// Dense FP8 GEMM with f32 scales (the 'promote' strategy), every layout:
//   d[m, n] = sum over 128-deep k blocks s of (a_s . b_s^T)[m, n] * sfb[s, n] * sfa[m, s]  (+ c[m, n])
// Replaces deepgemm_tpu/kernels/dense.py:_build_dense_gemm (pl.pallas_call at
// dense.py:291) for e4m3 operands under 'promote': the NT, NN, TN and TT
// layouts (A [m, k] or [k, m], B [n, k] or [k, n]; an MN-major operand is
// transposed stage by stage in shared memory, so each layout is bitwise the
// NT kernel on transposed copies), C added once to the finished f32 sum
// (dense.py:267-276), a bf16 or an f32 output, and planar FP4 B decoded to
// e4m3 in the kernel (decode_fp4_planar_block, dense.py:142-163; bitwise the
// e4m3 kernel on the decoded codes with per-row scales). The 'dequant'
// strategy and the folded FP4 operands are in dense_dequant.cu. The mainloop
// and its notes are in gemm_mainloop.cuh; this file is the C entry point,
// bound with ctypes.

#include "convert.cuh"
#include "gemm_mainloop.cuh"

namespace {

using dgt::Form;
using dgt::Scale;

template <bool kAMn, bool kBMn, bool kFp4B = false>
using Promote = Form<1, 1, Scale::kPromote, kAMn, kBMn, kFp4B>;

}  // namespace

// a [m, k] e4m3 ([k, m] when a_mn), b [n, k] e4m3 ([k, n] when b_mn; planar
// FP4 int8 [n, k/2] when fp4_b, k % 256 == 0), sfa [m, ceil(k/128)] f32,
// sfb [ceil(n/gran_n), ceil(k/128)] f32 with gran_n = 1 << sfb_shift, c [m, n]
// f32 or null, d [m, n] f32 when out_f32 else bf16. An MN-major operand's
// rows are whole 16-byte chunks (m or n % 16 == 0).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_dense_fp8_gemm(const void* a, const void* b, const void* sfa,
                                  const void* sfb, const void* c, void* d, int m, int n,
                                  int k, int sfb_shift, int block_n, int out_f32, int a_mn,
                                  int b_mn, int fp4_b, void* stream) {
    dgt::GemmArgs p = dgt::nt_args(a, b, sfa, sfb, d, m, n, k, sfb_shift);
    p.c = static_cast<const float*>(c);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    using dgt::launch_dense;
    cudaError_t err;
    if (fp4_b) {
        if (a_mn || b_mn) return static_cast<int>(cudaErrorInvalidValue);
        err = launch_dense<Promote<false, false, true>>(p, block_n, out_f32, s);
    } else if (a_mn) {
        err = b_mn ? launch_dense<Promote<true, true>>(p, block_n, out_f32, s)
                   : launch_dense<Promote<true, false>>(p, block_n, out_f32, s);
    } else {
        err = b_mn ? launch_dense<Promote<false, true>>(p, block_n, out_f32, s)
                   : launch_dense<Promote<false, false>>(p, block_n, out_f32, s);
    }
    return static_cast<int>(err);
}
