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
//   bf16 weights         bf16 x, bf16 products in one f32 sum; gate and up
//                        rounded to bf16 and back, silu in exp form; act
//                        bf16; bf16 L2.
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
//                        to e4m3 in shared memory. Every e2m1 value is an
//                        e4m3 value and code 0x8 decodes to +0, so an FP4
//                        instance gives the bits of the e4m3 instance fed
//                        the decoded weights.
// The silu form can be pinned for every instance (silu_tanh).
//
// Design: mega_sm90.cuh's body (wgmma + TMA, a producer warp and two
// consumer warpgroups, persistent), its items (expert, kN = 40 of its slot
// rows): at cap 40 one item an expert, 256 items at DeepSeek-V3 serving
// (1.94 waves of 132 SMs), each streaming its expert's weights once; the
// tiles of an expert with cap above 40 run on neighbouring blocks. The
// item's rows and act go through a scratch of kN rows a block (the
// wrapper's, for min(items, SMs) blocks).
//
// What bounds it on the H100: every expert's weights are streamed once,
// ~44 MB (fp8) per expert at DeepSeek-V3 widths against 40 slot rows, ~80
// operations per weight byte on bf16 products, under the bf16 rate's ~295:
// bytes bound (3.35 TB/s). FP4 weights are read twice from L2 (the two
// 128-deep blocks of one 128-byte plane), once from HBM.

#include "mega_sm90.cuh"

namespace dgt {
namespace mega {

template <W kW, bool kActFp8>
__global__ void __launch_bounds__(kThreads, 1)
mega_local_kernel(const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_w2,
                  const __grid_constant__ CUtensorMap map_act,
                  const __grid_constant__ CUtensorMap map_x, const __grid_constant__ Args p,
                  const __grid_constant__ LocalRows rows) {
    mega_body<kW, kActFp8>(map_w1, map_w2, map_act, map_x, p, rows);
}

template <W kW, bool kActFp8>
cudaError_t launch(const CUtensorMap& m1, const CUtensorMap& m2, const CUtensorMap& ma,
                   const CUtensorMap& mx, const Args& p, const LocalRows& rows, int grid,
                   cudaStream_t stream) {
    auto kernel = mega_local_kernel<kW, kActFp8>;
    const int smem = smem_bytes(p.inter);
    if (smem > sm90::kSmemLimit) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(m1, m2, ma, mx, p, rows);
    return cudaGetLastError();
}

}  // namespace mega
}  // namespace dgt

// weight_kind: 0 bf16 (x bf16, no scales), 1 e4m3, 2 planar FP4 (both with
// x e4m3 and f32 scales). act: the scratch of min(ceil(cap / 40)
// num_experts, the card's SMs) x 40 rows (dgt::mega::scratch_bytes). x [E, cap, H], xsf
// [E, cap, H/128], rw [E, cap], w1 [E, 2I, H], w2 [E, H, I] (FP4: k halved),
// w1sf [E, 2I/128, H/128], w2sf [E, H/128, I/128], y [E, cap, H] bf16;
// hidden and inter multiples of 128 (256 for FP4). Returns the launch's
// cudaError_t.
extern "C" int dgt_mega_local(const void* x, const void* xsf, const void* rw,
                              const void* w1, const void* w1sf, const void* w2,
                              const void* w2sf, void* act, void* y, int num_experts, int cap,
                              int hidden, int inter, int weight_kind, int act_fp8,
                              int silu_tanh, float clamp, void* stream) {
    using dgt::mega::W;
    using dgt::mega::kN;
    if (weight_kind < 0 || weight_kind > 2 || (weight_kind == 0 && act_fp8) || cap < 1 ||
        num_experts < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    dgt::mega::Args p = {};
    p.w1sf = static_cast<const float*>(w1sf);
    p.w2sf = static_cast<const float*>(w2sf);
    p.hidden = hidden;
    p.inter = inter;
    p.silu_tanh = silu_tanh;
    p.clamp = clamp;
    dgt::mega::LocalRows rows = {};
    rows.x = static_cast<const uint8_t*>(x);
    rows.xsf = static_cast<const float*>(xsf);
    rows.rw = static_cast<const float*>(rw);
    rows.y = static_cast<__nv_bfloat16*>(y);
    rows.experts = num_experts;
    rows.cap = cap;
    rows.tiles = (cap + kN - 1) / kN;
    rows.hidden = hidden;
    rows.x_row_bytes = static_cast<int64_t>(hidden) * (weight_kind == 0 ? 2 : 1);
    const int64_t items = static_cast<int64_t>(num_experts) * rows.tiles;
    if (dgt::mega::smem_bytes(inter) > dgt::sm90::kSmemLimit)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // one block an SM at most, each with its kN rows of the scratch
    const int grid = static_cast<int>(items < sms ? items : sms);
    dgt::mega::split_scratch(&p, act, static_cast<int64_t>(grid) * kN, weight_kind == 0 ? 2 : 1,
                             act_fp8 ? 1 : 2);
    CUtensorMap m1, m2, ma, mx;
    if (!dgt::mega::make_maps(&m1, &m2, &ma, &mx, w1, w2, p, num_experts, weight_kind, act_fp8,
                              static_cast<int64_t>(grid) * kN))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    using dgt::mega::launch;
    if (weight_kind == 0) err = launch<W::kBf16, false>(m1, m2, ma, mx, p, rows, grid, s);
    else if (weight_kind == 1)
        err = act_fp8 ? launch<W::kE4m3, true>(m1, m2, ma, mx, p, rows, grid, s)
                      : launch<W::kE4m3, false>(m1, m2, ma, mx, p, rows, grid, s);
    else
        err = act_fp8 ? launch<W::kFp4, true>(m1, m2, ma, mx, p, rows, grid, s)
                      : launch<W::kFp4, false>(m1, m2, ma, mx, p, rows, grid, s);
    return static_cast<int>(err);
}
