// The fused MoE expert block's body (L1, SwiGLU with clamp and row weight,
// optional fp8 requant, L2) over kRows slot rows of one expert, shared by
// the one-rank kernel (mega_local.cu) and the expert-parallel kernel
// (mega_ep.cu), so that a row's bits are the same in both. Where the rows
// come from and where their results go is the caller's Rows:
//   Rows::kLocal   the one-rank layout: rows r0 .. r0 + kRows - 1 of expert
//                  e in the wrapper's [E, cap, .] arrays, addressed here
//                  from p (kept as the one-rank kernel always computed it:
//                  through per-row pointers it ran ~8% slower on the H100,
//                  with the same bits)
//   otherwise      the caller's per-row tables: live(r) (row r of the block
//                  holds a slot row; else it reads as zero and is not
//                  written), x_row(r) its token bytes, xsf_at(r, kt) its
//                  scale of k block kt, rw_at(r) its top-k weight, act_row(r)
//                  its act bytes in the caller's scratch, y_row(r) where its
//                  bf16 result row goes (on a peer, in mega_ep.cu)
// Every row's result depends on that row alone, so any grouping of rows
// into blocks gives the same bits. Design notes and bounds: mega_local.cu.

#pragma once

#include "convert.cuh"
#include "gemm_mainloop.cuh"

namespace dgt {
namespace mega {

constexpr int kRows = 48;              // slot rows per block
constexpr int kMT = kRows / 16;        // m16 tiles
constexpr int kTile = 128;             // L1 columns (gate and up each) and L2 columns per tile
constexpr int kStages = 4;
constexpr int kL1StageBytes = (kRows + 2 * kTile) * kPitch;
constexpr int kRingBytes = kStages * kL1StageBytes;
constexpr int kWarps = kThreads / 32;

// L2 stage: 48 act rows of kABytes (+16) bytes, then 128 weight rows.
template <int kABytes>
__host__ __device__ constexpr int l2_stage_bytes() { return kRows * (kABytes + 16) + kTile * kPitch; }
static_assert(kStages * l2_stage_bytes<256>() <= kRingBytes, "the L2 ring reuses the L1 ring");

enum class W { kBf16, kE4m3, kFp4 };

struct Args {
    const uint8_t* x;       // [E, cap, H] e4m3 (bf16 for kBf16)
    const float* xsf;       // [E, cap, H/128] f32 (scaled)
    const float* rw;        // [E, cap] f32 row weights
    const uint8_t* w1;      // [E, 2I, H] gate rows then up rows (kFp4: [E, 2I, H/2] planar)
    const float* w1sf;      // [E, 2I/128, H/128]
    const uint8_t* w2;      // [E, H, I] (kFp4: [E, H, I/2] planar)
    const float* w2sf;      // [E, H/128, I/128]
    uint8_t* act;           // scratch [E, cap, I], bf16 or e4m3 (fp8 act)
    __nv_bfloat16* y;       // [E, cap, H]
    int cap, hidden, inter;
    int silu_tanh;          // 1: x * (0.5 tanh(x/2) + 0.5); 0: x / (1 + exp(-x))
    float clamp;            // silu(gate) * up is clipped at +-clamp
};

// Shared memory past the ring: act scales [kRows, I/128], the act-fp8 amax
// partials [kWarps, kRows], row weights [kRows].
__host__ __device__ constexpr int smem_bytes(int inter) {
    return kRingBytes + kRows * (inter / 128) * 4 + kWarps * kRows * 4 + kRows * 4;
}

// The weight fragment word at p (4 bytes of one row of a stage): as it is,
// or decoded from the FP4 plane of k block kt.
template <W kW>
__device__ __forceinline__ uint32_t weight_word(const uint8_t* p, int kt) {
    const uint32_t w = ld_shared_u32(p);
    if constexpr (kW == W::kFp4) return fp4x4_to_e4m3x4(w, kt & 1);
    else return w;
}

// Two weight bytes at p as e4m3 (decoded if FP4), widened to bf16x2.
template <W kW>
__device__ __forceinline__ uint32_t weight_pair_bf16(const uint8_t* p, int kt) {
    uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    if constexpr (kW == W::kFp4) w = fp4x4_to_e4m3x4(w, kt & 1);
    return e4m3x2_to_bf16x2(w);
}

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float silu(float g, int tanh_form) {
    if (tanh_form) return __fmul_rn(g, __fadd_rn(__fmul_rn(0.5f, tanhf(__fmul_rn(0.5f, g))), 0.5f));
    return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
}

// Copy rows of ``bytes`` (a multiple of 16) into a stage of row pitch
// ``pitch``: row i from src(i), or zeros where src(i) is null (the copy
// then reads nothing at ``any``).
template <class Src>
__device__ __forceinline__ void load_rows(uint8_t* stage, int rows, int bytes, int pitch,
                                          const uint8_t* any, Src src) {
    const int chunks = bytes / 16;
    for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
        const int r = c / chunks, ch = c % chunks;
        const uint8_t* row = src(r);
        cp_async16(smem_addr(stage + r * pitch + ch * 16), row ? row + ch * 16 : any,
                   row != nullptr);
    }
}

// The block's rows (kRows of them, through ``rows``) of expert e. The
// block's shared memory is the dynamic array from its start (the caller
// may keep its own data past smem_bytes(inter)); it is declared here, not
// passed, so every access to it stays a shared-memory access.
template <W kW, bool kActFp8, class Rows>
__device__ __forceinline__ void mega_block(const Args& p, const Rows& rows, const int e) {
    constexpr bool kScaled = kW != W::kBf16;
    constexpr bool kActBf16 = kScaled && !kActFp8;   // no bf16 round trip, no requant
    using Mma1 = typename std::conditional<kScaled, MmaE4m3, MmaBf16>::type;
    constexpr int kXBytes = kScaled ? 1 : 2;         // x and unscaled weights
    constexpr int kABytes = kActBf16 ? 2 * kKBytes : kKBytes;   // act bytes per L2 stage
    constexpr int kAPitch = kABytes + 16;
    constexpr int kL2StageBytes = l2_stage_bytes<kABytes>();
    extern __shared__ __align__(16) uint8_t smem[];

    const int H = p.hidden, I = p.inter;
    float* act_sf = reinterpret_cast<float*>(smem + kRingBytes);
    float* red = act_sf + kRows * (I / 128);
    float* rw = red + kWarps * kRows;

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wn = warp * 16;                        // warp's first column in a tile
    const int gr = lane >> 2, tg = lane & 3;

    constexpr bool kLocal = Rows::kLocal;
    constexpr int kActElem = kActFp8 ? 1 : 2;        // act bytes per element
    const int r0 = rows.r0;                          // kLocal: rows r0.. of expert e
    uint8_t* act = p.act + static_cast<int64_t>(e) * p.cap * I * kActElem;
    const uint8_t* x = p.x + (static_cast<int64_t>(e) * p.cap) * H * kXBytes;
    for (int r = tid; r < kRows; r += kThreads) {
        if constexpr (kLocal)
            rw[r] = r0 + r < p.cap ? __ldg(p.rw + static_cast<int64_t>(e) * p.cap + r0 + r) : 0.f;
        else
            rw[r] = rows.live(r) ? rows.rw_at(r) : 0.f;
    }

    // ---- L1: the I/128 tiles, their k blocks as one flat stream --------
    const int64_t w1_row_bytes = kW == W::kFp4 ? H / 2 : static_cast<int64_t>(H) * kXBytes;
    const uint8_t* w1 = p.w1 + static_cast<int64_t>(e) * 2 * I * w1_row_bytes;
    const int kt1 = H * kXBytes / kKBytes;            // k blocks (stages) per tile
    const int nt1 = I / kTile;
    const int ksf1 = H / 128;

    // stage rows [0, 48): x rows; [48, 176): gate rows; [176, 304): up rows
    auto load_l1 = [&](int slot, int g) {
        const int t = g / kt1, kt = g % kt1;
        const int64_t koff = kW == W::kFp4 ? (kt >> 1) * kKBytes : static_cast<int64_t>(kt) * kKBytes;
        load_rows(smem + slot * kL1StageBytes, kRows + 2 * kTile, kKBytes, kPitch, p.x,
                  [&](int r) -> const uint8_t* {
            if (r < kRows) {
                if constexpr (kLocal) {
                    if (r0 + r >= p.cap) return nullptr;
                    return x + static_cast<int64_t>(r0 + r) * H * kXBytes
                           + static_cast<int64_t>(kt) * kKBytes;
                } else {
                    if (!rows.live(r)) return nullptr;
                    return rows.x_row(r) + static_cast<int64_t>(kt) * kKBytes;
                }
            }
            const int wr = r - kRows;
            const int64_t row = (wr < kTile ? 0 : I - kTile) + t * kTile + wr;
            return w1 + row * w1_row_bytes + koff;
        });
    };

    float acc[kMT][4][4], part[kMT][4][4];
    auto zero = [](float (&v)[kMT][4][4]) {
        #pragma unroll
        for (int i = 0; i < kMT; ++i)
            #pragma unroll
            for (int j = 0; j < 4; ++j)
                #pragma unroll
                for (int q = 0; q < 4; ++q) v[i][j][q] = 0.f;
    };
    zero(acc);

    const int total1 = nt1 * kt1;
    #pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < total1) load_l1(s, s);
        cp_async_commit();
    }
    for (int g = 0; g < total1; ++g) {
        const int t = g / kt1, kt = g % kt1;
        cp_async_wait<kStages - 2>();
        __syncthreads();
        {
            const int ng = g + kStages - 1;
            if (ng < total1) load_l1(ng % kStages, ng);
            cp_async_commit();
        }
        const uint8_t* sa = smem + (g % kStages) * kL1StageBytes;
        const uint8_t* sb = sa + kRows * kPitch;
        if constexpr (kScaled) zero(part);
        #pragma unroll
        for (int kk = 0; kk < kKBytes; kk += 32) {
            uint32_t bfr[4][2];
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint8_t* pb = sb + ((j < 2 ? 0 : kTile) + wn + (j & 1) * 8 + gr) * kPitch
                                    + kk + tg * 4;
                bfr[j][0] = weight_word<kW>(pb, kt);
                bfr[j][1] = weight_word<kW>(pb + 16, kt);
            }
            #pragma unroll
            for (int i = 0; i < kMT; ++i) {
                uint32_t af[4];
                const uint8_t* pa = sa + (i * 16 + gr) * kPitch + kk + tg * 4;
                af[0] = ld_shared_u32(pa);
                af[1] = ld_shared_u32(pa + 8 * kPitch);
                af[2] = ld_shared_u32(pa + 16);
                af[3] = ld_shared_u32(pa + 8 * kPitch + 16);
                #pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if constexpr (kScaled) Mma1::mma(part[i][j], af, bfr[j]);
                    else Mma1::mma(acc[i][j], af, bfr[j]);
                }
            }
        }
        if constexpr (kScaled) {
            // acc += (p * sfw) * sfx; the tile's gate rows are all in scale
            // block t, its up rows in block I/128 + t
            const float* sf1 = p.w1sf + static_cast<int64_t>(e) * (2 * I / 128) * ksf1;
            const float sfw_gate = __ldg(sf1 + static_cast<int64_t>(t) * ksf1 + kt);
            const float sfw_up = __ldg(sf1 + static_cast<int64_t>(I / 128 + t) * ksf1 + kt);
            #pragma unroll
            for (int i = 0; i < kMT; ++i)
                #pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int lrow = i * 16 + gr + h * 8;
                    float sfx;
                    if constexpr (kLocal) {
                        const int row = r0 + lrow;
                        sfx = row < p.cap
                            ? __ldg(p.xsf + (static_cast<int64_t>(e) * p.cap + row) * ksf1 + kt)
                            : 0.f;
                    } else {
                        sfx = rows.live(lrow) ? rows.xsf_at(lrow, kt) : 0.f;
                    }
                    #pragma unroll
                    for (int j = 0; j < 4; ++j)
                        #pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const int v = 2 * h + c;
                            const float term = __fmul_rn(
                                __fmul_rn(part[i][j][v], j < 2 ? sfw_gate : sfw_up), sfx);
                            acc[i][j][v] = __fadd_rn(acc[i][j][v], term);
                        }
                }
        }
        if (kt != kt1 - 1) continue;

        // ---- the epilogue of tile t: SwiGLU, clamp, row weight (+requant)
        float a[kMT][2][4];
        #pragma unroll
        for (int i = 0; i < kMT; ++i)
            #pragma unroll
            for (int j = 0; j < 2; ++j)
                #pragma unroll
                for (int v = 0; v < 4; ++v) {
                    float gate = acc[i][j][v], up = acc[i][j + 2][v];
                    if constexpr (!kActBf16) {
                        gate = bf16_round(gate);
                        up = bf16_round(up);
                    }
                    float val = __fmul_rn(silu(gate, p.silu_tanh), up);
                    val = fminf(fmaxf(val, -p.clamp), p.clamp);
                    a[i][j][v] = __fmul_rn(val, rw[i * 16 + gr + (v >> 1) * 8]);
                }
        const int col0 = t * kTile + wn + tg * 2;
        if constexpr (!kActFp8) {
            #pragma unroll
            for (int i = 0; i < kMT; ++i)
                #pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int lrow = i * 16 + gr + h * 8;
                    const int row = r0 + lrow;
                    if constexpr (kLocal) {
                        if (row >= p.cap) continue;
                    } else {
                        if (!rows.live(lrow)) continue;
                    }
                    #pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        uint8_t* dst;
                        if constexpr (kLocal)
                            dst = act + (static_cast<int64_t>(row) * I + col0 + j * 8) * 2;
                        else
                            dst = rows.act_row(lrow) + (col0 + j * 8) * 2;
                        *reinterpret_cast<__nv_bfloat162*>(dst) =
                            __floats2bfloat162_rn(a[i][j][2 * h], a[i][j][2 * h + 1]);
                    }
                }
        } else {
            // per-row amax of the tile's 128 columns (bf16 values): the
            // thread's 4, the 4 threads of a row in the warp, the 8 warps
            float amax[kMT][2];
            #pragma unroll
            for (int i = 0; i < kMT; ++i)
                #pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float m = 0.f;
                    #pragma unroll
                    for (int j = 0; j < 2; ++j)
                        #pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            a[i][j][2 * h + c] = bf16_round(a[i][j][2 * h + c]);
                            m = fmaxf(m, fabsf(a[i][j][2 * h + c]));
                        }
                    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 1));
                    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, 2));
                    amax[i][h] = m;
                    if (tg == 0) red[warp * kRows + i * 16 + gr + h * 8] = m;
                }
            __syncthreads();
            #pragma unroll
            for (int i = 0; i < kMT; ++i)
                #pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int lrow = i * 16 + gr + h * 8;
                    float m = red[lrow];
                    #pragma unroll
                    for (int q = 1; q < kWarps; ++q) m = fmaxf(m, red[q * kRows + lrow]);
                    amax[i][h] = m;
                }
            __syncthreads();       // red is read by all before the next tile writes it
            #pragma unroll
            for (int i = 0; i < kMT; ++i)
                #pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int lrow = i * 16 + gr + h * 8;
                    const float sf = __fdiv_rn(fmaxf(amax[i][h], 1e-4f), 448.f);
                    const float inv = __fdiv_rn(1.f, sf);
                    if (warp == 0 && tg == 0) act_sf[lrow * (I / 128) + t] = sf;
                    uint8_t* arow;
                    if constexpr (kLocal) {
                        if (r0 + lrow >= p.cap) continue;
                        arow = act + static_cast<int64_t>(r0 + lrow) * I;
                    } else {
                        if (!rows.live(lrow)) continue;
                        arow = rows.act_row(lrow);
                    }
                    #pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const float q0 = fminf(fmaxf(__fmul_rn(a[i][j][2 * h], inv), -448.f), 448.f);
                        const float q1 = fminf(fmaxf(__fmul_rn(a[i][j][2 * h + 1], inv), -448.f), 448.f);
                        const __nv_fp8x2_storage_t q = __nv_cvt_float2_to_fp8x2(
                            make_float2(q0, q1), __NV_SATFINITE, __NV_E4M3);
                        *reinterpret_cast<__nv_fp8x2_storage_t*>(
                            arow + col0 + j * 8) = q;
                    }
                }
        }
        zero(acc);
    }
    cp_async_wait<0>();
    __threadfence_block();
    __syncthreads();       // act written; the ring is free

    // ---- L2: the H/128 tiles; A = act streamed back from the scratch -----
    const int64_t w2_row_bytes = kW == W::kFp4 ? I / 2 : static_cast<int64_t>(I) * kXBytes;
    const uint8_t* w2 = p.w2 + static_cast<int64_t>(e) * H * w2_row_bytes;
    const int kt2 = (kW == W::kBf16 ? I * 2 : I) / kKBytes;     // 128-byte weight stages
    const int nt2 = H / kTile;
    const int ksf2 = I / 128;
    const int total2 = nt2 * kt2;

    auto load_l2 = [&](int slot, int g) {
        const int u = g / kt2, kt = g % kt2;
        const int64_t koff = kW == W::kFp4 ? (kt >> 1) * kKBytes : static_cast<int64_t>(kt) * kKBytes;
        uint8_t* s = smem + slot * kL2StageBytes;
        load_rows(s, kRows, kABytes, kAPitch, p.x, [&](int r) -> const uint8_t* {
            if constexpr (kLocal) {
                if (r0 + r >= p.cap) return nullptr;
                return act + static_cast<int64_t>(r0 + r) * I * kActElem
                       + static_cast<int64_t>(kt) * kABytes;
            } else {
                if (!rows.live(r)) return nullptr;
                return rows.act_row(r) + static_cast<int64_t>(kt) * kABytes;
            }
        });
        load_rows(s + kRows * kAPitch, kTile, kKBytes, kPitch, p.x, [&](int r) -> const uint8_t* {
            return w2 + static_cast<int64_t>(u * kTile + r) * w2_row_bytes + koff;
        });
    };

    #pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < total2) load_l2(s, s);
        cp_async_commit();
    }
    float acc2[kMT][2][4], part2[kMT][2][4];
    auto zero2 = [](float (&v)[kMT][2][4]) {
        #pragma unroll
        for (int i = 0; i < kMT; ++i)
            #pragma unroll
            for (int j = 0; j < 2; ++j)
                #pragma unroll
                for (int q = 0; q < 4; ++q) v[i][j][q] = 0.f;
    };
    zero2(acc2);
    for (int g = 0; g < total2; ++g) {
        const int u = g / kt2, kt = g % kt2;
        cp_async_wait<kStages - 2>();
        __syncthreads();
        {
            const int ng = g + kStages - 1;
            if (ng < total2) load_l2(ng % kStages, ng);
            cp_async_commit();
        }
        const uint8_t* sa = smem + (g % kStages) * kL2StageBytes;
        const uint8_t* sb = sa + kRows * kAPitch;
        if constexpr (kScaled) zero2(part2);
        if constexpr (kActBf16) {
            // bf16 act x e4m3 weights widened to bf16: 8 k16 steps a block
            #pragma unroll
            for (int s = 0; s < 8; ++s) {
                uint32_t bfr[2][2];
                #pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const uint8_t* pb = sb + (wn + j * 8 + gr) * kPitch + s * 16 + tg * 2;
                    bfr[j][0] = weight_pair_bf16<kW>(pb, kt);
                    bfr[j][1] = weight_pair_bf16<kW>(pb + 8, kt);
                }
                #pragma unroll
                for (int i = 0; i < kMT; ++i) {
                    uint32_t af[4];
                    const uint8_t* pa = sa + (i * 16 + gr) * kAPitch + s * 32 + tg * 4;
                    af[0] = ld_shared_u32(pa);
                    af[1] = ld_shared_u32(pa + 8 * kAPitch);
                    af[2] = ld_shared_u32(pa + 16);
                    af[3] = ld_shared_u32(pa + 8 * kAPitch + 16);
                    #pragma unroll
                    for (int j = 0; j < 2; ++j) MmaBf16::mma(part2[i][j], af, bfr[j]);
                }
            }
        } else {
            #pragma unroll
            for (int kk = 0; kk < kKBytes; kk += 32) {
                uint32_t bfr[2][2];
                #pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const uint8_t* pb = sb + (wn + j * 8 + gr) * kPitch + kk + tg * 4;
                    bfr[j][0] = weight_word<kW>(pb, kt);
                    bfr[j][1] = weight_word<kW>(pb + 16, kt);
                }
                #pragma unroll
                for (int i = 0; i < kMT; ++i) {
                    uint32_t af[4];
                    const uint8_t* pa = sa + (i * 16 + gr) * kAPitch + kk + tg * 4;
                    af[0] = ld_shared_u32(pa);
                    af[1] = ld_shared_u32(pa + 8 * kAPitch);
                    af[2] = ld_shared_u32(pa + 16);
                    af[3] = ld_shared_u32(pa + 8 * kAPitch + 16);
                    #pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        if constexpr (kScaled) Mma1::mma(part2[i][j], af, bfr[j]);
                        else Mma1::mma(acc2[i][j], af, bfr[j]);
                    }
                }
            }
        }
        if constexpr (kScaled) {
            const float sfw = __ldg(p.w2sf + (static_cast<int64_t>(e) * nt2 + u) * ksf2 + kt);
            #pragma unroll
            for (int i = 0; i < kMT; ++i)
                #pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float sfa = 1.f;
                    if constexpr (kActFp8) sfa = act_sf[(i * 16 + gr + h * 8) * ksf2 + kt];
                    #pragma unroll
                    for (int j = 0; j < 2; ++j)
                        #pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            float term = __fmul_rn(part2[i][j][2 * h + c], sfw);
                            if constexpr (kActFp8) term = __fmul_rn(term, sfa);
                            acc2[i][j][2 * h + c] = __fadd_rn(acc2[i][j][2 * h + c], term);
                        }
                }
        }
        if (kt != kt2 - 1) continue;
        #pragma unroll
        for (int i = 0; i < kMT; ++i)
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int lrow = i * 16 + gr + h * 8;
                const int row = r0 + lrow;
                if constexpr (kLocal) {
                    if (row >= p.cap) continue;
                } else {
                    if (!rows.live(lrow)) continue;
                }
                #pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int col = u * kTile + wn + j * 8 + tg * 2;
                    __nv_bfloat16* dst;
                    if constexpr (kLocal)
                        dst = p.y + (static_cast<int64_t>(e) * p.cap + row) * H + col;
                    else
                        dst = rows.y_row(lrow) + col;
                    store_pair(dst,
                               acc2[i][j][2 * h], acc2[i][j][2 * h + 1]);
                }
            }
        zero2(acc2);
    }
    cp_async_wait<0>();
}

}  // namespace mega
}  // namespace dgt
