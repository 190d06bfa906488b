// Single-token decode attention over the KIVI cache.
//
// Replaces the TPU kernel `fused_decode_attention_wide` of
// kivi_tpu/kernels/fused_decode_wide.py (body `_kernel`).  Contract:
// kivi_tpu_torch/kernels/fused_decode_wide.py
// `fused_decode_attention_wide_plain` (the split two-half softmax of
// kivi_tpu/core/attention.py:156-216).
//
// Bound on the H100: bytes.  Each (batch, KV head) reads its live packed
// K and V codes, their bf16 scale/min rows and the fp windows once; at
// the full Llama-2-7B cache (B=8, H=32, 4096 tokens, 2-bit) that is
// about 118 MB, 35 us at 3.35 TB/s.  The FLOPs (2*r*D per position) are
// far below the card's rate.
//
// Design: one thread block of 128 threads per (batch, KV head), with
// the r = Hq/Hkv query rows of that head in shared memory.  The block
// walks the live positions [lo, seq_len) in chunks of 128, one online
// softmax across all of them:
//   * logits: thread i owns position c0+i.  A quantized position reads
//     its KDw words of the (KDw, T) store (coalesced across threads) and
//     dequantizes code*scale + min against the chunk's K scale rows,
//     staged in shared memory; a window position reads its k_win row.
//   * PV: thread d owns channel d.  The chunk's V codes and V scale/min
//     columns are staged in shared memory; V is routed by position:
//     pos < n_v_quant reads the V store, the rest read v_win row
//     pos - n_v_quant.
// Chunks below the per-row lower bound `lo` (left pad, sliding window)
// and beyond seq_len are never visited, so the kernel reads only the
// live part of the cache.  The counters arrive as ints.

#include "common.cuh"

namespace {

constexpr int NT = 128;      // threads per block == positions per chunk
constexpr int NW = NT / 32;

template <int R, typename ST>
__global__ void __launch_bounds__(NT)
fused_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const uint32_t* __restrict__ k_codes,
                    const ST* __restrict__ k_scale,
                    const ST* __restrict__ k_mn,
                    const uint32_t* __restrict__ v_codes,
                    const ST* __restrict__ v_scale,
                    const ST* __restrict__ v_mn,
                    const __nv_bfloat16* __restrict__ k_win,
                    const __nv_bfloat16* __restrict__ v_win,
                    const int* __restrict__ lo_ptr, float* __restrict__ out,
                    int H, int D, int Tmax, int W, int gs, int k_bits,
                    int v_bits, int nkq, int nkw, int nvq, float sm_scale) {
    extern __shared__ float sm[];
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

    const int bh = blockIdx.x, b = bh / H;
    const int tid = threadIdx.x;
    const int T_end = nkq + nkw;
    const int lo = lo_ptr ? max(lo_ptr[b], 0) : 0;

    for (int i = tid; i < R * D; i += NT)
        q_s[i] = to_f(q[(long long)bh * R * D + i]);

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
                const long long o = ((long long)bh * (Tmax / gs) + g0) * D + i;
                ks_s[i] = to_f(k_scale[o]);
                km_s[i] = to_f(k_mn[o]);
            }
        }
        if (c0 < nvq) {
            const int pos = c0 + tid;
            const bool in = pos < nvq;
            for (int w = 0; w < VDw; ++w)
                vc_s[w * NT + tid] =
                    in ? v_codes[((long long)bh * VDw + w) * Tmax + pos] : 0u;
            for (int g = 0; g < Dg; ++g) {
                const long long o = ((long long)bh * Dg + g) * Tmax + pos;
                vs_s[g * NT + tid] = in ? to_f(v_scale[o]) : 0.f;
                vm_s[g * NT + tid] = in ? to_f(v_mn[o]) : 0.f;
            }
        }
        __syncthreads();

        // ---- logits: thread tid owns position c0 + tid ----
        const int pos = c0 + tid;
        const bool valid = pos < T_end && pos >= lo;
        float s[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) s[rr] = 0.f;
        if (valid && pos < nkq) {
            const int g = pos / gs - c0 / gs;
            const float* ks = ks_s + g * D;
            const float* km = km_s + g * D;
            for (int w = 0; w < KDw; ++w) {
                const uint32_t word =
                    k_codes[((long long)bh * KDw + w) * Tmax + pos];
                for (int k = 0; k < 32 / k_bits; ++k) {
                    const int d = slot_channel(w, k, KDw, k_bits);
                    const float kv =
                        code_at(word, slot_shift(k, k_bits), k_bits) * ks[d]
                        + km[d];
#pragma unroll
                    for (int rr = 0; rr < R; ++rr) s[rr] += q_s[rr * D + d] * kv;
                }
            }
        } else if (valid) {
            const __nv_bfloat16* row =
                k_win + ((long long)bh * W + (pos - nkq)) * D;
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
        if (tid < D) {
            const int n = min(NT, T_end - c0);
            for (int i = 0; i < n; ++i) {
                const int p_pos = c0 + i;
                float v;
                if (p_pos < nvq) {
                    v = code_at(vc_s[v_w * NT + i], v_shift, v_bits)
                        * vs_s[v_g * NT + i] + vm_s[v_g * NT + i];
                } else {
                    v = to_f(v_win[((long long)bh * W + (p_pos - nvq)) * D
                                   + tid]);
                }
#pragma unroll
                for (int rr = 0; rr < R; ++rr) acc[rr] += p_s[rr * NT + i] * v;
            }
        }
    }
    if (tid < D) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
            out[((long long)bh * R + rr) * D + tid] =
                acc[rr] / (l[rr] > 0.f ? l[rr] : 1.f);
    }
}

template <int R, typename ST>
int launch(const void* q, const void* k_codes, const void* k_scale,
           const void* k_mn, const void* v_codes, const void* v_scale,
           const void* v_mn, const void* k_win, const void* v_win,
           const void* lo, void* out, int B, int H, int D, int Tmax, int W,
           int gs, int k_bits, int v_bits, int nkq, int nkw, int nvq,
           float sm_scale, cudaStream_t stream) {
    const int VDw = D / (32 / v_bits), Dg = D / gs, cg = NT / gs;
    const size_t smem = sizeof(float) * (size_t)(
        R * D + R * NT + 2 * cg * D + 2 * Dg * NT + R * NW + VDw * NT);
    auto kern = fused_decode_kernel<R, ST>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<B * H, NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes,
        (const ST*)k_scale, (const ST*)k_mn, (const uint32_t*)v_codes,
        (const ST*)v_scale, (const ST*)v_mn, (const __nv_bfloat16*)k_win,
        (const __nv_bfloat16*)v_win, (const int*)lo, (float*)out, H, D,
        Tmax, W, gs, k_bits, v_bits, nkq, nkw, nvq, sm_scale);
    return (int)cudaGetLastError();
}

template <typename ST>
int dispatch_r(int r, const void* q, const void* kc, const void* ks,
               const void* km, const void* vc, const void* vs,
               const void* vm, const void* kw, const void* vw,
               const void* lo, void* out, int B, int H, int D, int Tmax,
               int W, int gs, int kb, int vb, int nkq, int nkw, int nvq,
               float sm_scale, cudaStream_t st) {
#define KIVI_R(RR)                                                       \
    case RR:                                                             \
        return launch<RR, ST>(q, kc, ks, km, vc, vs, vm, kw, vw, lo, out, \
                              B, H, D, Tmax, W, gs, kb, vb, nkq, nkw,    \
                              nvq, sm_scale, st);
    switch (r) {
        KIVI_R(1) KIVI_R(2) KIVI_R(4) KIVI_R(8)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_R
}

}  // namespace

extern "C" int kivi_fused_decode(const void* q, const void* k_codes,
                                 const void* k_scale, const void* k_mn,
                                 const void* v_codes, const void* v_scale,
                                 const void* v_mn, const void* k_win,
                                 const void* v_win, const void* lo,
                                 void* out, int B, int H, int r, int D,
                                 int Tmax, int W, int gs, int k_bits,
                                 int v_bits, int n_k_quant, int n_k_win,
                                 int n_v_quant, int scale_is_f32,
                                 float sm_scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32)
        return dispatch_r<float>(r, q, k_codes, k_scale, k_mn, v_codes,
                                 v_scale, v_mn, k_win, v_win, lo, out, B, H,
                                 D, Tmax, W, gs, k_bits, v_bits, n_k_quant,
                                 n_k_win, n_v_quant, sm_scale, st);
    return dispatch_r<__nv_bfloat16>(r, q, k_codes, k_scale, k_mn, v_codes,
                                     v_scale, v_mn, k_win, v_win, lo, out,
                                     B, H, D, Tmax, W, gs, k_bits, v_bits,
                                     n_k_quant, n_k_win, n_v_quant,
                                     sm_scale, st);
}
