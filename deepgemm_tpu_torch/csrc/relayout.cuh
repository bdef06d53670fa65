// The transposing gather that lays one-byte operands out k-major for the
// Hopper mainloop (gemm_sm90.cuh), which takes e4m3 from shared memory
// k-major only: the FP8 k-grouped kernel's TN operands (k_grouped.cu, each
// group at its own 128-column block) and the dense kernel's MN-major
// operands (dense.cu, the identity for src). Each library that includes it
// exports its own dgt_k_major_relayout, counted by its own wrapper.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dgt {

// dst[d, c] = x[src[c], d], or zero where src[c] < 0: tiles of 128 source
// rows by 128 bytes, read and written in whole 128-byte lines (16 bytes a
// thread); each thread turns four 4 x 4 byte blocks by __byte_perm. With
// src the identity it is a transposing copy (the dense kernel's MN-major
// operands, kernels/dense.py).
__global__ void __launch_bounds__(256)
k_major_relayout_kernel(const uint8_t* __restrict__ x, const int* __restrict__ src,
                        uint8_t* __restrict__ dst, int dim, long long ldk) {
    __shared__ uint32_t tile[128][33];       // [d][c / 4], padded
    const int t = threadIdx.x;
    const long long c0 = static_cast<long long>(blockIdx.x) * 128;
    const int d0 = blockIdx.y * 128;
    const int cb = t / 8, dc = t % 8;        // columns c0 + 4 cb .. + 3, bytes d0 + 16 dc .. + 15
    const int d = d0 + 16 * dc;
    const bool chunks = (dim & 15) == 0;
    uint32_t w[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long c = c0 + 4 * cb + i;
        const int row = c < ldk ? src[c] : -1;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row >= 0 && d < dim) {
            const uint8_t* p = x + static_cast<long long>(row) * dim + d;
            if (chunks) {
                v = __ldg(reinterpret_cast<const uint4*>(p));
            } else {
                uint32_t b[4] = {0, 0, 0, 0};
                for (int e = 0; e < 16 && d + e < dim; ++e)
                    b[e / 4] |= static_cast<uint32_t>(__ldg(p + e)) << (8 * (e % 4));
                v = make_uint4(b[0], b[1], b[2], b[3]);
            }
        }
        w[i][0] = v.x;
        w[i][1] = v.y;
        w[i][2] = v.z;
        w[i][3] = v.w;
    }
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t lo01 = __byte_perm(w[0][k], w[1][k], 0x5140);
        const uint32_t hi01 = __byte_perm(w[0][k], w[1][k], 0x7362);
        const uint32_t lo23 = __byte_perm(w[2][k], w[3][k], 0x5140);
        const uint32_t hi23 = __byte_perm(w[2][k], w[3][k], 0x7362);
        const int r = 16 * dc + 4 * k;
        tile[r][cb] = __byte_perm(lo01, lo23, 0x5410);
        tile[r + 1][cb] = __byte_perm(lo01, lo23, 0x7632);
        tile[r + 2][cb] = __byte_perm(hi01, hi23, 0x5410);
        tile[r + 3][cb] = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int id = t + 256 * i, r = id / 8, ch = id % 8;
        if (d0 + r < dim && c0 + 16 * ch < ldk) {
            const uint4 out = make_uint4(tile[r][4 * ch], tile[r][4 * ch + 1], tile[r][4 * ch + 2],
                                         tile[r][4 * ch + 3]);
            *reinterpret_cast<uint4*>(dst + static_cast<long long>(d0 + r) * ldk + c0 + 16 * ch) =
                out;
        }
    }
}

// x [rows, dim] bytes, src [ldk] int32, dst [dim, ldk] bytes; ldk % 16 == 0.
// Returns the cudaError_t of the launch (0 = success).
inline int launch_k_major_relayout(const void* x, const void* src, void* dst, int dim,
                                   long long ldk, void* stream) {
    if (ldk % 16 != 0 || ldk <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((ldk + 127) / 128), (dim + 127) / 128);
    k_major_relayout_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int*>(src), static_cast<uint8_t*>(dst),
        dim, ldk);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace dgt
