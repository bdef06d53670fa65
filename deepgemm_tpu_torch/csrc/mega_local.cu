// The fused MoE expert block at one rank (the mega kernel's D=1 form):
//   gu  = x[e, r] . w1[e]^T                     (gate | up, f32)
//   act = clip(silu(gate) * up, +-clamp) * rw[e, r]     (clamp 256 in the model)
//   y[e, r] = act . w2[e]^T                     (bf16)
// for every expert e and every one of its cap slot rows r, in one launch.
//
// Replaces deepgemm_tpu/kernels/fused_moe.py:_mega_kernel_local
// (pl.pallas_call at fused_moe.py:690, _mega_local_call), with the
// arithmetic of _promote_dot, _silu, _l1_epilogue and _decode_fp4_chunk
// (fused_moe.py:204-340).
//
// Five instances (kW, kActFp8):
//   bf16 weights         bf16 x, bf16 MMA; gate and up rounded to bf16 and
//                        back, silu in exp form; act bf16; bf16 L2.
//   e4m3, act bf16       the f32 promotion over 128-deep k blocks,
//                        acc += (p * sfw[n]) * sfx[r]; no bf16 round trip,
//                        silu in tanh form; act bf16; L2 bf16 act x e4m3
//                        weights widened to bf16 (exact), acc += p * sfw[n].
//   e4m3, act fp8        bf16 round trip, exp silu, then each row's act is
//                        requantized per 128 columns (amax clipped at 1e-4,
//                        sf = amax / 448, q = e4m3(clip(v * (1/sf), +-448)));
//                        L2 is the fp8 promotion with the act scales.
//   planar FP4, act bf16 / act fp8: as the e4m3 instances, each 128-deep k
//                        block of the weights decoded from its nibble plane
//                        to e4m3 in registers. Every e2m1 value is an e4m3
//                        value and code 0x8 decodes to +0, so an FP4
//                        instance gives the bits of the e4m3 instance fed
//                        the decoded weights.
// The silu form can be pinned for every instance (silu_tanh).
//
// Design (right and simple first):
//   * One block owns one expert and kRows = 48 of its slot rows (all 40 of
//     the DeepSeek-V3 serving shape), and no other block reads its act: it
//     loops over the I/128 L1 tiles (128 gate columns and the same 128 up
//     columns, so one thread holds gate and up of one element), writes act
//     to a scratch in device memory that the wrapper allocates ([E, cap, I],
//     42 MB in bf16 at that shape, most of it still in the 50 MB L2 when it
//     is read back), then loops over the H/128 L2 tiles streaming act from
//     there beside the weights. No atomics, no second launch, and no L1
//     work is repeated. Grid (ceil(cap / 48), E).
//   * Why the scratch: bf16 act for 48 rows is 192 KB at I = 2048, which
//     leaves no room in the 227 KB a block may use for a ring of weight
//     stages deep enough to keep HBM busy. Keeping 32 rows of act in shared
//     memory beside 2 stages instead splits cap 40 into row blocks of 32
//     and 8; that form took 11.3 ms on one H100 at the DeepSeek-V3 serving
//     shape, slower than the unfused masked kernels (PERF.md). Here every
//     phase has a 4-stage cp.async ring: L1 stages of
//     48 x rows and 256 weight rows, 128 bytes of k each (rows padded to 144
//     bytes), 175,104 bytes in all; L2 stages of 48 act rows (128 or 256
//     bytes) and 128 weight rows in the same space.
//   * 8 warps side by side over the columns, each 48 rows (3 m16 tiles) x 16
//     gate and 16 up columns in L1, 48 x 16 in L2; mma.sync m16n8k32 e4m3 or
//     m16n8k16 bf16 with f32 accumulation; scales and the epilogue in
//     registers with explicit _rn intrinsics (nothing contracted into an
//     FMA). The act-fp8 amax crosses the 8 warps through shared memory; its
//     scales stay in shared memory.
//   * Rows past cap read as zero and are not written.
//
// What bounds it on the H100: every expert's weights are streamed once,
// ~44 MB (fp8) per expert at DeepSeek-V3 widths against 40 slot rows, ~80
// operations per weight byte: bytes bound (3.35 TB/s). 256 blocks are ~1.94
// waves of 132 SMs. FP4 weights are read twice from L2 (the two 128-deep
// blocks of one 128-byte plane), once from HBM. What limits this form is
// the mma.sync rate (~150 TFLOP/s for the whole card, as the shared
// mainloop): wgmma and TMA are the next step.

#include "mega_block.cuh"

namespace dgt {
namespace mega {

// The one-rank kernel's rows: r0 .. r0 + kRows - 1 of expert e's cap slot
// rows, addressed in the body from the wrapper's [E, cap, .] layout.
struct LocalRows {
    static constexpr bool kLocal = true;
    int r0;
};

template <W kW, bool kActFp8>
__global__ void __launch_bounds__(kThreads)
mega_local_kernel(const Args p) {
    mega_block<kW, kActFp8>(p, LocalRows{static_cast<int>(blockIdx.x) * kRows}, blockIdx.y);
}

template <W kW, bool kActFp8>
cudaError_t launch(const Args& p, int num_experts, cudaStream_t stream) {
    auto kernel = mega_local_kernel<kW, kActFp8>;
    const int smem = smem_bytes(p.inter);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.cap + kRows - 1) / kRows, num_experts);
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace mega
}  // namespace dgt

// weight_kind: 0 bf16 (x bf16, no scales), 1 e4m3, 2 planar FP4 (both with
// x e4m3 and f32 scales). act: the scratch [E, cap, I] of act_fp8 ? 1 : 2
// bytes an element. Shapes as in dgt::mega::Args; hidden and inter
// multiples of 128 (256 for FP4). Returns the launch's cudaError_t.
extern "C" int dgt_mega_local(const void* x, const void* xsf, const void* rw,
                              const void* w1, const void* w1sf, const void* w2,
                              const void* w2sf, void* act, void* y, int num_experts, int cap,
                              int hidden, int inter, int weight_kind, int act_fp8,
                              int silu_tanh, float clamp, void* stream) {
    using dgt::mega::W;
    dgt::mega::Args p = {};
    p.x = static_cast<const uint8_t*>(x);
    p.xsf = static_cast<const float*>(xsf);
    p.rw = static_cast<const float*>(rw);
    p.w1 = static_cast<const uint8_t*>(w1);
    p.w1sf = static_cast<const float*>(w1sf);
    p.w2 = static_cast<const uint8_t*>(w2);
    p.w2sf = static_cast<const float*>(w2sf);
    p.act = static_cast<uint8_t*>(act);
    p.y = static_cast<__nv_bfloat16*>(y);
    p.cap = cap;
    p.hidden = hidden;
    p.inter = inter;
    p.silu_tanh = silu_tanh;
    p.clamp = clamp;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    if (weight_kind == 0 && !act_fp8) err = dgt::mega::launch<W::kBf16, false>(p, num_experts, s);
    else if (weight_kind == 1) err = act_fp8 ? dgt::mega::launch<W::kE4m3, true>(p, num_experts, s)
                                             : dgt::mega::launch<W::kE4m3, false>(p, num_experts, s);
    else if (weight_kind == 2) err = act_fp8 ? dgt::mega::launch<W::kFp4, true>(p, num_experts, s)
                                             : dgt::mega::launch<W::kFp4, false>(p, num_experts, s);
    return static_cast<int>(err);
}
