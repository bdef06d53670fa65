// Register-level conversions of narrow operand types, shared by the Hopper
// GEMM mainloop (gemm_sm90.cuh), the mega MoE block (mega_sm90.cuh) and the
// indexer logits body (mqa_sm90.cuh):
//   * planar FP4 (e2m1) codes -> e4m3 bytes, exact (every e2m1 value is an
//     e4m3 value), by one __byte_perm table lookup;
//   * e4m3 pairs -> bf16x2, exact, for a bf16 MMA on an e4m3 operand;
//   * a bf16x2 product rounded once (the 'dequant' scale multiply).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace dgt {

__device__ __forceinline__ uint32_t ld_shared_u16(const uint8_t* p) {
    return *reinterpret_cast<const uint16_t*>(p);
}

// Four planar FP4 codes (nibble plane nib of four bytes) -> four e4m3 bytes.
__device__ __forceinline__ uint32_t fp4x4_to_e4m3x4(uint32_t w, int nib) {
    const uint32_t c = (w >> (4 * nib)) & 0x0F0F0F0Fu;
    const uint32_t sel = (c & 0x7u) | ((c >> 4) & 0x70u) | ((c >> 8) & 0x700u) | ((c >> 12) & 0x7000u);
    // magnitudes 0, 0.5, 1, 1.5 | 2, 3, 4, 6 as e4m3 bytes
    const uint32_t dec = __byte_perm(0x3C383000u, 0x4C484440u, sel);
    const uint32_t nonzero = ((dec >> 4) | (dec >> 6)) & 0x01010101u;
    const uint32_t sign = (c >> 3) & 0x01010101u;
    return dec | ((sign & nonzero) << 7);
}

// Two e4m3 bytes (low half of v) -> a bf16x2 register, exact.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t v) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v & 0xFFFFu),
                                                     __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<const uint32_t*>(&b);
}

// f32 s rounded to bf16, in both halves of a bf16x2 register.
__device__ __forceinline__ uint32_t bf16x2_splat(float s) {
    const __nv_bfloat162 b = __float2bfloat162_rn(s);
    return *reinterpret_cast<const uint32_t*>(&b);
}

// x * s per bf16 half, rounded once to nearest even (an fma with -0 adds
// nothing and keeps the sign of an exact zero product).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t s) {
    uint32_t r;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(s), "r"(0x80008000u));
    return r;
}

}  // namespace dgt
