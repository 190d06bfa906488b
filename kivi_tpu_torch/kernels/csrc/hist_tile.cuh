// The quantized history as tensor-core operands: raw staging of a chunk
// of packed K/V words and scales by cp.async, and its dequantization into
// the bf16 operand tiles of attn_wgmma.cuh.  Shared by flash_extend.cu
// (the full extend kernel) and flash_extend_qhist.cu (the history part,
// split over T), so the two extend kernels dequantize with one body.
//
// A chunk holds CK history positions [c0, c0 + CK).  Its raw staging
// buffer (layout `raw_layout`) holds the packed K and V words (KDw, CK)
// and (VDw, CK), the chunk's ngk K scale/min rows (ngk, D) and its V
// scale/min columns (Dg, CK).  The NT threads of the block then write the
// DP-column operand tiles (core-matrix layout, attn_wgmma.cuh):
//   * K^ = code * scale, rounded to bf16 once, for positions below
//     n_k_quant; rows at or past it are left to the caller.  K's zero
//     point stays apart: Z holds the chunk's K min rows split into hi
//     (rows 0-7) and lo (rows 8-15) bf16 rows, Q Z^T goes through wgmma,
//     and `add_qmn` adds each group's q . mn to the f32 logits (folding
//     mn into the bf16 operand would round it with the far larger
//     code * scale + mn).
//   * V^ = code * scale + mn, rounded to bf16 once, for positions below
//     n_v_quant; rows at or past it are left to the caller.
// Rounding, as the Pallas kernels at their default compute_dtype=bf16
// (kivi_tpu/kernels/flash_extend.py): bf16 operands, f32 accumulation.
#pragma once

#include "attn_wgmma.cuh"

namespace hq {

constexpr int NT = 256;   // threads of a block: two warpgroups
constexpr int DP = 128;   // operand tile columns (D <= 128 zero-padded)

// Byte offsets of one raw staging buffer.  Every offset is a multiple of
// 16 (D % 16 == 0, CK * sb >= 128).
struct Raw {
    int kw, vw, ks, km, vs, vm, bytes;
};

template <int CK>
__host__ __device__ inline Raw raw_layout(int KDw, int VDw, int ngk, int D,
                                          int Dg, int sb) {
    Raw r;
    r.kw = 0;
    r.vw = r.kw + KDw * CK * 4;
    r.ks = r.vw + VDw * CK * 4;
    r.km = r.ks + ngk * D * sb;
    r.vs = r.km + ngk * D * sb;
    r.vm = r.vs + Dg * CK * sb;
    r.bytes = r.vm + Dg * CK * sb;
    return r;
}

// Stage chunk c0 of (batch * KV head) bh raw into the buffer at shared
// address `base`: K words below nkq, V words below nvq, the K scale/min
// rows of the groups starting below nkq, the V scale/min columns below
// nvq; everything else zero-filled.  4 words (or 16 bytes of scales) a
// copy; gs = 1 << gsh, Tg = Tmax >> gsh, Dg = D >> gsh,
// ngk = max(1, CK >> gsh).
template <int CK, typename ST>
__device__ __forceinline__ void stage_raw(
        uint32_t base, const Raw& rl, const uint32_t* k_codes,
        const ST* k_scale, const ST* k_mn, const uint32_t* v_codes,
        const ST* v_scale, const ST* v_mn, long long bh, int c0, int KDw,
        int VDw, int D, int Dg, int Tmax, int Tg, int ngk, int gsh, int nkq,
        int nvq) {
    constexpr int SB = sizeof(ST);
    const int tid = threadIdx.x;
    const char* const kc = (const char*)k_codes;
    const char* const vc = (const char*)v_codes;
    for (int i = tid; i < KDw * (CK / 4); i += NT) {
        const int w = i / (CK / 4), c = i % (CK / 4), pos = c0 + 4 * c;
        const bool ok = pos < nkq;
        const long long o = ((bh * KDw + w) * Tmax + pos) * 4;
        wg::cp16(base + rl.kw + (w * CK + 4 * c) * 4, ok ? kc + o : kc, ok);
    }
    for (int i = tid; i < VDw * (CK / 4); i += NT) {
        const int w = i / (CK / 4), c = i % (CK / 4), pos = c0 + 4 * c;
        const bool ok = pos < nvq;
        const long long o = ((bh * VDw + w) * Tmax + pos) * 4;
        wg::cp16(base + rl.vw + (w * CK + 4 * c) * 4, ok ? vc + o : vc, ok);
    }
    const char* const ks = (const char*)k_scale;
    const char* const km = (const char*)k_mn;
    const int rowc = D * SB / 16;          // copies per K scale row
    for (int i = tid; i < ngk * rowc; i += NT) {
        const int gi = i / rowc, c = i % rowc, g = (c0 >> gsh) + gi;
        const bool ok = g < Tg && (g << gsh) < nkq;
        const long long o = (bh * Tg + g) * D * SB + c * 16;
        const uint32_t so = gi * D * SB + c * 16;
        wg::cp16(base + rl.ks + so, ok ? ks + o : ks, ok);
        wg::cp16(base + rl.km + so, ok ? km + o : km, ok);
    }
    const char* const vs = (const char*)v_scale;
    const char* const vm = (const char*)v_mn;
    const int colc = CK * SB / 16;         // copies per V scale row
    for (int i = tid; i < Dg * colc; i += NT) {
        const int g = i / colc, c = i % colc, pos = c0 + c * (16 / SB);
        const bool ok = pos < nvq;
        const long long o = ((bh * Dg + g) * Tmax + pos) * SB;
        const uint32_t so = g * CK * SB + c * 16;
        wg::cp16(base + rl.vs + so, ok ? vs + o : vs, ok);
        wg::cp16(base + rl.vm + so, ok ? vm + o : vm, ok);
    }
}

// Word (pos, w) of a chunk goes to lane (pos % 8, w % 4) of a warp, so a
// warp's stores fill one 8-row core matrix without bank conflicts.
template <int CK>
__device__ __forceinline__ void word_task(int idx, int* kj, int* w) {
    const int rest = idx >> 5;
    *kj = (rest % (CK / 8)) * 8 + (idx & 7);
    *w = (rest / (CK / 8)) * 4 + ((idx >> 3) & 3);
}

// K^ rows of the chunk's positions below nkq, at BITS bits.  Scale rows
// ks_s (ngk, D); chunk position kj reads row (c0 % gs + kj) >> gsh.
template <int CK, int BITS, typename ST>
__device__ __forceinline__ void dequant_k(uint8_t* __restrict__ tile,
                                          const uint32_t* __restrict__ kw_s,
                                          const ST* __restrict__ ks_s,
                                          int c0, int nkq, int D, int gsh) {
    const int Dw = D / (32 / BITS), cmod = c0 & ((1 << gsh) - 1);
    for (int idx = threadIdx.x; idx < ((Dw + 3) & ~3) * CK; idx += NT) {
        int kj, w;
        word_task<CK>(idx, &kj, &w);
        if (w >= Dw || c0 + kj >= nkq) continue;
        const uint32_t word = kw_s[w * CK + kj];
        const ST* const sr = ks_s + ((cmod + kj) >> gsh) * D;
        if (BITS == 8) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int d = j * Dw + w;
                *(__nv_bfloat16*)(tile + wg::tile_off<DP>(kj, d)) =
                    __float2bfloat16((float)((word >> (8 * j)) & 255u)
                                     * to_f(sr[d]));
            }
        } else {
            constexpr uint32_t mask = (1u << BITS) - 1u;
#pragma unroll
            for (int j = 0; j < 16 / BITS; ++j) {
                const int d = j * 2 * Dw + 2 * w;
                *(uint32_t*)(tile + wg::tile_off<DP>(kj, d)) = wg::pack_bf16(
                    (float)((word >> (BITS * j)) & mask) * to_f(sr[d]),
                    (float)((word >> (16 + BITS * j)) & mask)
                        * to_f(sr[d + 1]));
            }
        }
    }
}

// V^ rows of the chunk's positions below nvq, at BITS bits.  Scale
// columns vs_s, vm_s (Dg, CK).
template <int CK, int BITS, typename ST>
__device__ __forceinline__ void dequant_v(uint8_t* __restrict__ tile,
                                          const uint32_t* __restrict__ vw_s,
                                          const ST* __restrict__ vs_s,
                                          const ST* __restrict__ vm_s,
                                          int c0, int nvq, int D, int gsh) {
    const int Dw = D / (32 / BITS);
    for (int idx = threadIdx.x; idx < ((Dw + 3) & ~3) * CK; idx += NT) {
        int kj, w;
        word_task<CK>(idx, &kj, &w);
        if (w >= Dw || c0 + kj >= nvq) continue;
        const uint32_t word = vw_s[w * CK + kj];
        if (BITS == 8) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int d = j * Dw + w, g = ((d >> gsh) * CK) + kj;
                *(__nv_bfloat16*)(tile + wg::tile_off<DP>(kj, d)) =
                    __float2bfloat16(fmaf((float)((word >> (8 * j)) & 255u),
                                          to_f(vs_s[g]), to_f(vm_s[g])));
            }
        } else {
            constexpr uint32_t mask = (1u << BITS) - 1u;
#pragma unroll
            for (int j = 0; j < 16 / BITS; ++j) {
                const int d = j * 2 * Dw + 2 * w, g = ((d >> gsh) * CK) + kj;
                const float sc = to_f(vs_s[g]), mn = to_f(vm_s[g]);
                *(uint32_t*)(tile + wg::tile_off<DP>(kj, d)) = wg::pack_bf16(
                    fmaf((float)((word >> (BITS * j)) & mask), sc, mn),
                    fmaf((float)((word >> (16 + BITS * j)) & mask), sc, mn));
            }
        }
    }
}

// Dequantize the raw buffer `raw` of chunk c0 into K^ (p_k), V^ (p_v) and
// the zero-point rows Z (p_z): bits dispatched at run time, the unpack
// itself a template.
template <int CK, typename ST>
__device__ __forceinline__ void dequant_chunk(
        uint8_t* p_k, uint8_t* p_v, uint8_t* p_z, const uint8_t* raw,
        const Raw& rl, int c0, int nkq, int nvq, int D, int ngk, int gsh,
        int k_bits, int v_bits) {
    const uint32_t* const kw_s = (const uint32_t*)(raw + rl.kw);
    const uint32_t* const vw_s = (const uint32_t*)(raw + rl.vw);
    const ST* const ks_s = (const ST*)(raw + rl.ks);
    const ST* const km_s = (const ST*)(raw + rl.km);
    const ST* const vs_s = (const ST*)(raw + rl.vs);
    const ST* const vm_s = (const ST*)(raw + rl.vm);
    if (k_bits == 2)
        dequant_k<CK, 2>(p_k, kw_s, ks_s, c0, nkq, D, gsh);
    else if (k_bits == 4)
        dequant_k<CK, 4>(p_k, kw_s, ks_s, c0, nkq, D, gsh);
    else
        dequant_k<CK, 8>(p_k, kw_s, ks_s, c0, nkq, D, gsh);
    if (v_bits == 2)
        dequant_v<CK, 2>(p_v, vw_s, vs_s, vm_s, c0, nvq, D, gsh);
    else if (v_bits == 4)
        dequant_v<CK, 4>(p_v, vw_s, vs_s, vm_s, c0, nvq, D, gsh);
    else
        dequant_v<CK, 8>(p_v, vw_s, vs_s, vm_s, c0, nvq, D, gsh);
    // Z: the chunk's K min rows, hi (rows 0-7) and lo (rows 8-15); rows
    // of groups at or past nkq were zero-filled by stage_raw
    for (int idx = threadIdx.x; idx < 8 * DP; idx += NT) {
        const int gi = idx / DP, d = idx % DP;
        if (d >= D) continue;
        const float x = gi < ngk ? to_f(km_s[gi * D + d]) : 0.f;
        const __nv_bfloat16 hi = __float2bfloat16(x);
        *(__nv_bfloat16*)(p_z + wg::tile_off<DP>(gi, d)) = hi;
        *(__nv_bfloat16*)(p_z + wg::tile_off<DP>(gi + 8, d)) =
            __float2bfloat16(x - __bfloat162float(hi));
    }
}

// Add q . mn to the chunk's logits s (the m64nCKk16 fragment of
// Q K^T), from z, the fragment of Q Z^T (m64n16): q . mn of group g, row
// h sits in lane (lane & ~3) | g / 2 of the quad, as z[2h + g % 2] +
// z[4 + 2h + g % 2].  Needs CK / gs <= 8.
template <int CK>
__device__ __forceinline__ void add_qmn(float (&s)[CK / 2],
                                        const float (&z)[8], int c0, int gs,
                                        int gsh) {
    const int lane = threadIdx.x & 31;
    float zs[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) zs[h][e] = z[2 * h + e] + z[4 + 2 * h + e];
    const int cmod = c0 & (gs - 1);
#pragma unroll
    for (int j = 0; j < CK / 8; ++j) {
        const int g = (cmod + 8 * j) >> gsh;    // warp-uniform, < 8
        const int src = (lane & ~3) | (g >> 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float zz = __shfl_sync(0xffffffffu,
                                         (g & 1) ? zs[h][1] : zs[h][0], src);
            s[4 * j + 2 * h] += zz;
            s[4 * j + 2 * h + 1] += zz;
        }
    }
}

}  // namespace hq
