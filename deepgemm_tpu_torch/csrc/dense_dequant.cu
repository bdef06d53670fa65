// Dense GEMM forms on the bf16 MMA: the 'dequant' scale strategy and the
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
//     mixed forms here take that bf16 operand beside an e4m3 one, widened to
//     bf16 as its fragment is loaded, under 'promote' (the e4m3 side's
//     scales per 128-deep block) or 'dequant'; two folded operands run
//     bf16 x bf16.
// The e4m3 x e4m3 'dequant' form takes every layout (MN-major operands
// transposed in shared memory, gemm_mainloop.cuh); the mixed forms take
// k-major operands (FP4 operands are k-major; the op layer makes the other
// one k-major).
//
// Bound on the H100: the same bytes as the e4m3 forms, but m16n8k16 runs at
// the bf16 rate, half of e4m3's: at 4096 x 4096 x 7168 operations bound it.

#include "convert.cuh"
#include "gemm_mainloop.cuh"

namespace {

using dgt::Form;
using dgt::Scale;

template <bool kAMn, bool kBMn>
using Dequant = Form<1, 1, Scale::kDequant, kAMn, kBMn>;

}  // namespace

// a, b: e4m3 or bf16 (a_bf16, b_bf16), a [m, k] ([k, m] when a_mn), b [n, k]
// ([k, n] when b_mn; MN-major only for e4m3 x e4m3 'dequant'); sfa
// [m, ceil(k/128)] f32 for an e4m3 A, sfb [ceil(n/gran_n), ceil(k/128)] f32
// for an e4m3 B (gran_n = 1 << sfb_shift), null for a bf16 operand; dequant:
// 1 'dequant', 0 'promote' (at least one e4m3 operand); c [m, n] f32 or null;
// d [m, n] f32 when out_f32 else bf16. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int dgt_dense_gemm_bf16_mma(const void* a, const void* b, const void* sfa,
                                       const void* sfb, const void* c, void* d, int m, int n,
                                       int k, int sfb_shift, int block_n, int out_f32,
                                       int a_mn, int b_mn, int a_bf16, int b_bf16, int dequant,
                                       void* stream) {
    dgt::GemmArgs p = dgt::nt_args(a, b, sfa, sfb, d, m, n, k, sfb_shift);
    p.c = static_cast<const float*>(c);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    using dgt::launch_dense;
    if ((a_bf16 || b_bf16) && (a_mn || b_mn)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    if (a_bf16 && b_bf16) {
        err = launch_dense<Form<2, 2, Scale::kNone>>(p, block_n, out_f32, s);
    } else if (a_bf16) {
        err = dequant ? launch_dense<Form<2, 1, Scale::kDequant>>(p, block_n, out_f32, s)
                      : launch_dense<Form<2, 1, Scale::kPromote>>(p, block_n, out_f32, s);
    } else if (b_bf16) {
        err = dequant ? launch_dense<Form<1, 2, Scale::kDequant>>(p, block_n, out_f32, s)
                      : launch_dense<Form<1, 2, Scale::kPromote>>(p, block_n, out_f32, s);
    } else if (!dequant) {
        return static_cast<int>(cudaErrorInvalidValue);    // e4m3 'promote': dense.cu
    } else if (a_mn) {
        err = b_mn ? launch_dense<Dequant<true, true>>(p, block_n, out_f32, s)
                   : launch_dense<Dequant<true, false>>(p, block_n, out_f32, s);
    } else {
        err = b_mn ? launch_dense<Dequant<false, true>>(p, block_n, out_f32, s)
                   : launch_dense<Dequant<false, false>>(p, block_n, out_f32, s);
    }
    return static_cast<int>(err);
}
