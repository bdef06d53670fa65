// Contiguous m-grouped NT GEMM, bf16 or scaled FP8:
//   d[m, n] = a[m, k] . b[gid(m-tile)][n, k]^T   (fp8: the f32 promotion per 128-k block)
// Replaces deepgemm_tpu/kernels/grouped.py:_build_contiguous (pl.pallas_call at
// grouped.py:240). The rows of a and d are the groups' row blocks, each
// starting on a multiple of the mk alignment (128, a multiple of the 64-row
// tile), so no tile straddles two groups. Each tile's group and its group's
// end row come from tile_gid / tile_row_end, which the wrapper computes on the
// device from grouped_layout (kernels/grouped.py:compute_tile_gids): the
// host never reads the layout. The mainloop and its notes are in
// gemm_mainloop.cuh.

#include "gemm_mainloop.cuh"

// a [m, k], b [G, n, k] (both bf16, or both e4m3 with sfa [m, ceil(k/128)] f32
// and sfb [G, ceil(n/gran_n), ceil(k/128)] f32, gran_n = 1 << sfb_shift),
// tile_gid [ceil(m/64)] int32, tile_row_end [ceil(m/64)] int32 or null (rows at
// or past it are written as zero: ensure_zero_padding), d [m, n] bf16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dgt_contiguous_gemm_nt(const void* a, const void* b, const void* sfa,
                                      const void* sfb, const void* tile_gid,
                                      const void* tile_row_end, void* d, int m, int n,
                                      int k, int is_fp8, int sfb_shift, int block_n,
                                      void* stream) {
    dgt::GemmArgs p = dgt::nt_args(a, b, sfa, sfb, d, m, n, k, sfb_shift);
    p.tile_gid = static_cast<const int*>(tile_gid);
    p.tile_row_end = static_cast<const int*>(tile_row_end);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr auto kContiguous = dgt::Layout::kContiguous;
    const cudaError_t err =
        is_fp8 ? dgt::launch_gemm_nt_bn<dgt::MmaE4m3, true, kContiguous, __nv_bfloat16>(
                     p, 1, block_n, s)
               : dgt::launch_gemm_nt_bn<dgt::MmaBf16, false, kContiguous, __nv_bfloat16>(
                     p, 1, block_n, s);
    return static_cast<int>(err);
}
