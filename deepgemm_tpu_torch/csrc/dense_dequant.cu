// Dense GEMM forms on bf16 products: the 'dequant' scale strategy and the
// folded FP4 operands.
//
// Replaces deepgemm_tpu/kernels/dense.py:_build_dense_gemm (pl.pallas_call at
// dense.py:291) where JAX runs it
//   * under 'dequant' (dense.py:248-255; chosen by deepgemm_tpu/ops/gemm.py:
//     208-228 when both operands' scales are provably powers of two, packed
//     UE8M0 int32 or folded FP4): each e4m3 operand widened to bf16 times its
//     scale rounded to bf16 (exact for powers of two), one full-depth sum
//     into a single f32 accumulator, no per-block partial;
//     d = sum_k (bf16(a) * bf16(sfa)) (bf16(b) * bf16(sfb))  (+ c);
//   * on a packed FP4 operand whose scale granularity (32 or 64) is finer
//     than a promotion block: JAX folds the operand into bf16 values
//     (deepgemm_tpu/ops/gemm.py:137-170), which leave e4m3's range, and runs
//     the kernel on e4m3 x bf16 with unit scales on the folded side. The
//     mixed forms take that bf16 operand beside an e4m3 one, under 'promote'
//     (the e4m3 side's scales per 128-deep block) or 'dequant'; two folded
//     operands run bf16 x bf16.
// Every form runs the Hopper mainloop of gemm_sm90.cuh (TMA-fed 128-byte
// swizzled stages, one producer lane, consumer warpgroups on wgmma, a
// persistent grid, the TMA-store epilogue): bf16 x bf16 is the dense
// kernel's unscaled form (gemm_kernel), the forms with an e4m3 operand are
// widen_kernel (an e4m3 A widened into wgmma's register operand, an e4m3 B
// widened in shared memory). The operands are k-major: the wrapper makes an
// MN-major e4m3 operand k-major first (dgt_k_major_relayout of dense.cu), so
// the NN, TN and TT layouts are bitwise NT.
//
// Bound on the H100: the same bytes as the e4m3 forms, but bf16 products run
// at the bf16 rate, half of e4m3's: at 4096 x 4096 x 7168 operations bound it
// (0.2432 ms at 989 TFLOP/s). What the design spends beside the wgmma: every
// e4m3 code of a tile widened once a tile (a prmt, a shift and a mask a pair,
// then one or two bf16x2 products), (kBM + kBN) x 128 a stage against 2 kBM
// kBN x 128 operations.

#include "gemm_sm90.cuh"

// a [m, k] and b [n, k], each e4m3 or (a_bf16, b_bf16) bf16; sfa [m, ksf]
// f32 for an e4m3 A, sfb [nsf, ksf] f32 for an e4m3 B (ksf = ceil(k/128),
// nsf = ceil(n / gran_n), gran_n = 1 << sfb_shift), null for a bf16
// operand; scratch ksf * (sfa_ld + sfb_ld) f32 for their k-first copies
// (sfa_ld: m rounded up to 4, or 0 without sfa; sfb_ld: nsf rounded up to 4,
// or 0 without sfb); dequant: 1 'dequant', 0 'promote' (one e4m3 operand:
// e4m3 x e4m3 'promote' is dense.cu's); c [m, n] f32 or null; d [m, n] f32
// when out_f32 else bf16; k % 16 == 0, n even. block_m (64 or 128), block_n
// (128, or 64 beside block_m 64 where an e4m3 operand is widened),
// num_stages and num_sms from the tile chooser (heuristics/configs.py:
// get_sm90_config). Returns the cudaError_t of the launches (0 = success).
extern "C" int dgt_dense_gemm_bf16_mma(const void* a, const void* b, const void* sfa,
                                       const void* sfb, void* scratch, const void* c, void* d,
                                       int m, int n, int k, int sfa_ld, int sfb_ld, int sfb_shift,
                                       int block_m, int block_n, int num_stages, int num_sms,
                                       int out_f32, int a_bf16, int b_bf16, int dequant,
                                       void* stream) {
    using namespace dgt::sm90;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((sfa == nullptr) != (sfa_ld == 0) || (sfb == nullptr) != (sfb_ld == 0) ||
        (a_bf16 != 0) != (sfa == nullptr) || (b_bf16 != 0) != (sfb == nullptr) ||
        (!a_bf16 && !b_bf16 && !dequant) || (a_bf16 && b_bf16 && block_n != kDenseBN))
        return static_cast<int>(cudaErrorInvalidValue);
    const int ksf = (k + kBK - 1) / kBK;
    const int nsf = ((n - 1) >> sfb_shift) + 1;
    cudaError_t err = cudaSuccess;
    if (sfa_ld + sfb_ld > 0) {
        err = launch_k_first(sfa, sfb, scratch, m, nsf, ksf, sfa_ld, sfb_ld, sfb != nullptr, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const uint64_t a_row = static_cast<uint64_t>(k) * (a_bf16 ? 2 : 1);
    const uint64_t b_row = static_cast<uint64_t>(k) * (b_bf16 ? 2 : 1);
    CUtensorMap map_a, map_b;
    if (!make_map(&map_a, a, a_row, m, a_row, block_m) ||
        !make_map(&map_b, b, b_row, n, b_row, block_n))
        return static_cast<int>(cudaErrorInvalidValue);
    Args p = {};
    p.sfa = static_cast<const float*>(scratch);
    p.sfb = p.sfa + static_cast<int64_t>(ksf) * sfa_ld;
    p.c = static_cast<const float*>(c);
    p.d = d;
    p.M = m;
    p.N = n;
    p.sfa_ld = sfa_ld;
    p.sfb_ld = sfb_ld;
    p.sfb_shift = sfb_shift;
    p.num_groups = 1;
    p.num_stages = num_stages;
    // a stage: 128 bytes of k (gemm_kernel), or 128 values (widen_kernel)
    p.num_kb = a_bf16 && b_bf16 ? (2 * k + kBK - 1) / kBK : ksf;
    constexpr Operand kE4m3 = Operand::kE4m3, kBf16 = Operand::kBf16;
    const int bm = block_m, bn = block_n;
    if (a_bf16 && b_bf16)
        err = launch_any<Kind::kDense, BForm::kUnscaled>(map_a, map_b, p, bm, out_f32, num_sms, s);
    else if (!a_bf16 && !b_bf16)
        err = launch_widen_any<kE4m3, kE4m3, true>(map_a, map_b, p, bm, bn, out_f32, num_sms, s);
    else if (b_bf16)
        err = dequant
            ? launch_widen_any<kE4m3, kBf16, true>(map_a, map_b, p, bm, bn, out_f32, num_sms, s)
            : launch_widen_any<kE4m3, kBf16, false>(map_a, map_b, p, bm, bn, out_f32, num_sms, s);
    else
        err = dequant
            ? launch_widen_any<kBf16, kE4m3, true>(map_a, map_b, p, bm, bn, out_f32, num_sms, s)
            : launch_widen_any<kBf16, kE4m3, false>(map_a, map_b, p, bm, bn, out_f32, num_sms, s);
    return static_cast<int>(err);
}
