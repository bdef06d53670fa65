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
//
// The dual-B entry replaces deepgemm_tpu/kernels/grouped.py:
// _build_contiguous_dual_b (pl.pallas_call at grouped.py:401): the same
// function over 256-row tiles (Layout::kContiguousDual), for layouts whose
// groups start on 128 but not always on 256 rows. A tile whose two 128-row
// halves belong to different groups stages both groups' B; any other tile
// stages one B for 256 rows, where the 64-row tiles stage it four times.
// Its bits are the 64-row kernel's: each 64-row pass is that kernel's tile.
//
// The NN entry is the same kernel over an MN-major B [G, k, n] (the NN
// layout of deepgemm_tpu/ops/m_grouped.py, B's BlockSpec at grouped.py:139-145):
// each stage's B tile is loaded as it lies and transposed in shared memory
// (gemm_mainloop.cuh), so its bits are the NT kernel's on
// b.transpose(1, 2).contiguous().

#include "convert.cuh"
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
        is_fp8 ? dgt::launch_gemm_bn<dgt::FormE4m3, kContiguous, __nv_bfloat16>(p, 1, block_n, s)
               : dgt::launch_gemm_bn<dgt::FormBf16, kContiguous, __nv_bfloat16>(p, 1, block_n, s);
    return static_cast<int>(err);
}

// The NN form: the arguments of dgt_contiguous_gemm_nt with b [G, k, n]
// (n % 16 == 0 for e4m3, n % 8 == 0 for bf16: whole 16-byte rows); the
// scales as there, sfb [G, ceil(n/gran_n), ceil(k/128)]. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int dgt_contiguous_gemm_nn(const void* a, const void* b, const void* sfa,
                                      const void* sfb, const void* tile_gid,
                                      const void* tile_row_end, void* d, int m, int n,
                                      int k, int is_fp8, int sfb_shift, int block_n,
                                      void* stream) {
    dgt::GemmArgs p = dgt::nt_args(a, b, sfa, sfb, d, m, n, k, sfb_shift);
    p.tile_gid = static_cast<const int*>(tile_gid);
    p.tile_row_end = static_cast<const int*>(tile_row_end);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr auto kContiguous = dgt::Layout::kContiguous;
    using E4m3Nn = dgt::Form<1, 1, dgt::Scale::kPromote, false, true>;
    using Bf16Nn = dgt::Form<2, 2, dgt::Scale::kNone, false, true>;
    const cudaError_t err =
        is_fp8 ? dgt::launch_gemm_bn<E4m3Nn, kContiguous, __nv_bfloat16>(p, 1, block_n, s)
               : dgt::launch_gemm_bn<Bf16Nn, kContiguous, __nv_bfloat16>(p, 1, block_n, s);
    return static_cast<int>(err);
}

// The dual-B form: a, b, sfa, sfb, d and is_fp8 as above; m % 256 == 0;
// tile_gid [m/128] int32, the group of each 128-row half (pairs per 256-row
// tile). The tile is 64 columns wide: two B slabs of 128 columns exceed the
// shared memory of a block. Returns the cudaError_t of the launch (0 = success).
static_assert(dgt::smem_bytes<dgt::FormE4m3, 64, dgt::Layout::kContiguousDual>() <= 232448,
              "the dual-B tile must fit the 227 KiB an H100 block may use");
extern "C" int dgt_contiguous_dual_gemm_nt(const void* a, const void* b, const void* sfa,
                                           const void* sfb, const void* tile_gid, void* d,
                                           int m, int n, int k, int is_fp8, int sfb_shift,
                                           void* stream) {
    dgt::GemmArgs p = dgt::nt_args(a, b, sfa, sfb, d, m, n, k, sfb_shift);
    p.tile_gid = static_cast<const int*>(tile_gid);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr auto kDual = dgt::Layout::kContiguousDual;
    const cudaError_t err =
        is_fp8 ? dgt::launch_gemm<dgt::FormE4m3, 64, kDual, __nv_bfloat16>(p, 1, s)
               : dgt::launch_gemm<dgt::FormBf16, 64, kDual, __nv_bfloat16>(p, 1, s);
    return static_cast<int>(err);
}
