// Shared helpers for the port's CUDA kernels: the packed word layout of
// kivi_tpu_torch/core/quant.py, scalar loads of the storage types, a
// block-wide reduction (the decode kernels) and the KIVI decode body of
// one (row, KV head) (the two KIVI decode kernels and, with ablations,
// the decode probe).  The prefill and the two extend kernels run on the
// tensor-core tile of attn_wgmma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// Finite "minus infinity" of the attention masks (never -inf: exp of a
// difference of two -inf is NaN).
#define KIVI_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

// Slot k of a packed word, k in [0, 32/bits): the channel it holds and
// the bit position of its code.
//   crumbs (2/4-bit): slot k = j*2 + h  ->  channel j*(2*Dw) + 2*w + h,
//                     bits [16*h + bits*j, +bits)
//   planes (8-bit):   slot k = j        ->  channel j*Dw + w, bits [8*j, +8)
__device__ __forceinline__ int slot_channel(int w, int k, int Dw, int bits) {
    if (bits == 8) return k * Dw + w;
    const int j = k >> 1, h = k & 1;
    return j * (2 * Dw) + 2 * w + h;
}
__device__ __forceinline__ int slot_shift(int k, int bits) {
    if (bits == 8) return 8 * k;
    return 16 * (k & 1) + bits * (k >> 1);
}

// Inverse map: word and bit position of channel d.
__device__ __forceinline__ void channel_slot(int d, int Dw, int bits,
                                             int* w, int* shift) {
    if (bits == 8) {
        *w = d % Dw;
        *shift = 8 * (d / Dw);
    } else {
        const int j = d / (2 * Dw), rem = d % (2 * Dw);
        *w = rem >> 1;
        *shift = 16 * (rem & 1) + bits * j;
    }
}

__device__ __forceinline__ float code_at(uint32_t word, int shift, int bits) {
    return (float)((word >> shift) & ((1u << bits) - 1u));
}

// Reduce R values per thread across a block of NT threads (max or sum);
// every thread gets the R results.  red: R * (NT / 32) floats of shared
// memory.  Ends with a barrier, so it also orders shared writes made
// before it.
template <int R, int NT>
__device__ __forceinline__ void block_reduce(float (&v)[R], float* red,
                                             bool is_max) {
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
        float x = v[rr];
        for (int o = 16; o > 0; o >>= 1) {
            const float y = __shfl_xor_sync(0xffffffffu, x, o);
            x = is_max ? fmaxf(x, y) : x + y;
        }
        if (lane == 0) red[rr * NW + warp] = x;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
        float x = red[rr * NW];
        for (int w = 1; w < NW; ++w)
            x = is_max ? fmaxf(x, red[rr * NW + w]) : x + red[rr * NW + w];
        v[rr] = x;
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// Single-token KIVI decode attention of one (batch row, KV head), shared by
// fused_decode.cu (counters uniform over the batch, passed as ints) and
// fused_decode_rows.cu (counters read per row from the device), and by
// trimmed.cu (the ablations below, at full fill).  A block of
// NT = 128 threads holds the R query rows of the head in shared memory and
// walks the live positions [lo, nkq + nkw) in chunks of NT, one online
// softmax across all of them:
//   * logits: thread i owns position c0+i.  A quantized position reads
//     its KDw words of the (KDw, T) store (coalesced across threads) and
//     dequantizes code*scale + min against the chunk's K scale rows,
//     staged in shared memory; a window position reads its k_win row.
//   * PV: thread d owns channel d.  The chunk's V codes and V scale/min
//     columns are staged in shared memory; V is routed by position:
//     pos < nvq reads the V store, the rest read v_win row pos - nvq.
// Chunks below `lo` (left pad, sliding window) and past nkq + nkw are
// never visited.  A head with no admitted position writes exact zeros
// (p is zeroed by the mask, so l stays 0).
//
// The ablation parameter A takes one part of the quantized positions'
// work out at a time, for the decode probe (trimmed.cu); the decode
// kernels run Ablation<0>, the full body.  An ablated branch is not
// compiled into another variant.
//   0 full           K scales per element: q . (c * s + mn)
//   1 fold           each group's K scale folded into the query rows once
//                    per chunk: sum_d (q_d s_d) c + sum_d q_d mn_d
//   2 none           the chunk's first K scale row for every position
//   3 no V path      the PV product replaced by the probability of the
//                    chunk's first position
//   4 fold, no V path
//   5 no QK          logit = q . mn + sum_d c_d s_d (the unpack and scale
//                    stay live, the products with q go)
//   6 no unpack      every slot of a word reads its low `bits` bits
//   7 dma only       2, 3, 5 and 6 at once: the loads, and the output of 3
// Every variant stages the chunk's K scales, V codes and V scales as the
// full body does.
// ---------------------------------------------------------------------------
namespace kdec {

constexpr int NT = 128;      // threads per block == positions per chunk
constexpr int NW = NT / 32;

enum Scales { ELEMENT = 0, FOLD = 1, NONE = 2 };

template <int VAR>
struct Ablation {
    static constexpr int scales = (VAR == 1 || VAR == 4) ? FOLD
                                  : (VAR == 2 || VAR == 7) ? NONE
                                                           : ELEMENT;
    static constexpr bool qk = !(VAR == 5 || VAR == 7);
    static constexpr bool vpath = !(VAR == 3 || VAR == 4 || VAR == 7);
    static constexpr bool unpack = !(VAR == 6 || VAR == 7);
    // the zero-point term q . mn per (group, row) is staged once per
    // chunk where the logits need it apart from the K values
    static constexpr bool zp = scales == FOLD || !qk;
};

// zp: add the (cg, R, D) folded query rows and (cg, R) zero-point terms
// of an ablation that stages them (Ablation<VAR>::zp).
inline size_t smem_bytes(int R, int D, int gs, int v_bits, bool zp = false) {
    const int VDw = D / (32 / v_bits), Dg = D / gs, cg = NT / gs;
    return sizeof(float) * (size_t)(R * D + R * NT + 2 * cg * D
                                    + 2 * Dg * NT + R * NW + VDw * NT
                                    + (zp ? cg * R * D + cg * R : 0));
}

// Pointers are those of batch row b's KV head h (bh = b*H + h): q (R, D),
// k_codes (KDw, Tmax), k_scale/k_mn (Tmax/gs, D), v_codes (VDw, Tmax),
// v_scale/v_mn (D/gs, Tmax), k_win/v_win (W, D), out (R, D).
template <int R, typename ST, typename A = Ablation<0>>
__device__ __forceinline__ void attend(
        float* sm, const __nv_bfloat16* __restrict__ q,
        const uint32_t* __restrict__ k_codes, const ST* __restrict__ k_scale,
        const ST* __restrict__ k_mn, const uint32_t* __restrict__ v_codes,
        const ST* __restrict__ v_scale, const ST* __restrict__ v_mn,
        const __nv_bfloat16* __restrict__ k_win,
        const __nv_bfloat16* __restrict__ v_win, float* __restrict__ out,
        int D, int Tmax, int gs, int k_bits, int v_bits, int nkq, int nkw,
        int nvq, int lo, float sm_scale) {
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int Dg = D / gs, cg = NT / gs;
    float* q_s = sm;                          // (R, D)
    float* p_s = q_s + R * D;                 // (R, NT)
    float* ks_s = p_s + R * NT;               // (cg, D)
    float* km_s = ks_s + cg * D;              // (cg, D)
    float* vs_s = km_s + cg * D;              // (Dg, NT)
    float* vm_s = vs_s + Dg * NT;             // (Dg, NT)
    float* red = vm_s + Dg * NT;              // (R, NW)
    uint32_t* vc_s = (uint32_t*)(red + R * NW);   // (VDw, NT)
    float* qs_s = (float*)(vc_s + VDw * NT);  // (cg, R, D) ablations only
    float* zp_s = qs_s + cg * R * D;          // (cg, R) ablations only

    const int tid = threadIdx.x;
    const int T_end = nkq + nkw;
    lo = max(lo, 0);

    for (int i = tid; i < R * D; i += NT) q_s[i] = to_f(q[i]);

    float m[R], l[R], acc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
        m[rr] = KIVI_NEG_INF;
        l[rr] = 0.f;
        acc[rr] = 0.f;
    }
    const int kw_d = tid < D ? tid : 0;       // this thread's PV channel
    int v_w, v_shift;
    channel_slot(kw_d, VDw, v_bits, &v_w, &v_shift);
    const int v_g = kw_d / gs;

    for (int c0 = (lo / NT) * NT; c0 < T_end; c0 += NT) {
        __syncthreads();   // previous chunk's readers are done
        if (c0 < nkq) {
            const int g0 = c0 / gs;
            const int ng = min(cg, (nkq - c0 + gs - 1) / gs);
            for (int i = tid; i < ng * D; i += NT) {
                const long long o = (long long)g0 * D + i;
                ks_s[i] = to_f(k_scale[o]);
                km_s[i] = to_f(k_mn[o]);
            }
        }
        if (c0 < nvq) {
            const int pos = c0 + tid;
            const bool in = pos < nvq;
            for (int w = 0; w < VDw; ++w)
                vc_s[w * NT + tid] =
                    in ? v_codes[(long long)w * Tmax + pos] : 0u;
            for (int g = 0; g < Dg; ++g) {
                const long long o = (long long)g * Tmax + pos;
                vs_s[g * NT + tid] = in ? to_f(v_scale[o]) : 0.f;
                vm_s[g * NT + tid] = in ? to_f(v_mn[o]) : 0.f;
            }
        }
        __syncthreads();
        if (A::zp && c0 < nkq) {
            const int ng = min(cg, (nkq - c0 + gs - 1) / gs);
            if (A::scales == FOLD) {
                for (int i = tid; i < ng * R * D; i += NT) {
                    const int g = i / (R * D), rd = i % (R * D);
                    qs_s[i] = q_s[rd] * ks_s[g * D + rd % D];
                }
            }
            // one warp per (group, row): lanes over D, then a shuffle sum
            // (a loop over D in one thread per (group, row) ran the 32K
            // probe's zero-point variants 0.17 ms slower on an H100)
            const int lane = tid & 31, warp = tid >> 5;
            for (int i = warp; i < ng * R; i += NW) {
                const int g = i / R, rr = i % R;
                float z = 0.f;
                for (int d = lane; d < D; d += 32)
                    z += q_s[rr * D + d] * km_s[g * D + d];
                for (int o = 16; o > 0; o >>= 1)
                    z += __shfl_xor_sync(0xffffffffu, z, o);
                if (lane == 0) zp_s[i] = z;
            }
        }
        if (A::zp) __syncthreads();

        // ---- logits: thread tid owns position c0 + tid ----
        const int pos = c0 + tid;
        const bool valid = pos < T_end && pos >= lo;
        float s[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) s[rr] = 0.f;
        if (valid && pos < nkq) {
            const int g = pos / gs - c0 / gs;
            const float* ks = ks_s + (A::scales == NONE ? 0 : g) * D;
            const float* km = km_s + g * D;
            const float* qs = qs_s + g * R * D;
            float sum_cs = 0.f;
            for (int w = 0; w < KDw; ++w) {
                const uint32_t word = k_codes[(long long)w * Tmax + pos];
                for (int k = 0; k < 32 / k_bits; ++k) {
                    const int d = slot_channel(w, k, KDw, k_bits);
                    const float c =
                        A::unpack ? code_at(word, slot_shift(k, k_bits), k_bits)
                                  : (float)(word & ((1u << k_bits) - 1u));
                    if (!A::qk) {
                        sum_cs += c * ks[d];
                    } else if (A::scales == FOLD) {
#pragma unroll
                        for (int rr = 0; rr < R; ++rr)
                            s[rr] += qs[rr * D + d] * c;
                    } else {
                        const float kv = c * ks[d] + km[d];
#pragma unroll
                        for (int rr = 0; rr < R; ++rr)
                            s[rr] += q_s[rr * D + d] * kv;
                    }
                }
            }
            if (A::zp) {
#pragma unroll
                for (int rr = 0; rr < R; ++rr)
                    s[rr] += zp_s[g * R + rr] + (A::qk ? 0.f : sum_cs);
            }
        } else if (valid) {
            const __nv_bfloat16* row = k_win + (long long)(pos - nkq) * D;
            for (int d = 0; d < D; ++d) {
                const float kv = to_f(row[d]);
#pragma unroll
                for (int rr = 0; rr < R; ++rr) s[rr] += q_s[rr * D + d] * kv;
            }
        }
        float cmax[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            s[rr] *= sm_scale;
            cmax[rr] = valid ? s[rr] : KIVI_NEG_INF;
        }
        block_reduce<R, NT>(cmax, red, true);
        float alpha[R], psum[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            const float m_new = fmaxf(m[rr], cmax[rr]);
            alpha[rr] = expf(m[rr] - m_new);
            const float p = valid ? expf(s[rr] - m_new) : 0.f;
            p_s[rr * NT + tid] = p;
            psum[rr] = p;
            m[rr] = m_new;
        }
        block_reduce<R, NT>(psum, red, false);  // also orders p_s writes
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
            l[rr] = l[rr] * alpha[rr] + psum[rr];
            acc[rr] *= alpha[rr];
        }

        // ---- PV: thread tid owns channel tid ----
        if (tid < D && !A::vpath) {
#pragma unroll
            for (int rr = 0; rr < R; ++rr) acc[rr] += p_s[rr * NT];
        } else if (tid < D) {
            const int n = min(NT, T_end - c0);
            for (int i = 0; i < n; ++i) {
                const int p_pos = c0 + i;
                float v;
                if (p_pos < nvq) {
                    v = code_at(vc_s[v_w * NT + i], v_shift, v_bits)
                        * vs_s[v_g * NT + i] + vm_s[v_g * NT + i];
                } else {
                    v = to_f(v_win[(long long)(p_pos - nvq) * D + tid]);
                }
#pragma unroll
                for (int rr = 0; rr < R; ++rr) acc[rr] += p_s[rr * NT + i] * v;
            }
        }
    }
    if (tid < D) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
            out[rr * D + tid] = acc[rr] / (l[rr] > 0.f ? l[rr] : 1.f);
    }
}

}  // namespace kdec
