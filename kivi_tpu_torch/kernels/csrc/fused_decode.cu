// Single-token decode attention over the KIVI cache, counters uniform over
// the batch.
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
// Design: one thread block of 128 threads per (batch, KV head), the body
// `kdec::attend` of common.cuh (shared with fused_decode_rows.cu, the
// per-row-counter kernel).  The counters arrive as ints, the same for
// every block; the per-row lower bound `lo` (left pad, sliding window)
// from the device.

#include "common.cuh"

namespace {

using kdec::NT;

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
    const long long bh = blockIdx.x;
    const int b = (int)(bh / H);
    const int KDw = D / (32 / k_bits), VDw = D / (32 / v_bits);
    const int Dg = D / gs;
    kdec::attend<R, ST>(
        sm, q + bh * R * D, k_codes + bh * KDw * Tmax,
        k_scale + bh * (Tmax / gs) * D, k_mn + bh * (Tmax / gs) * D,
        v_codes + bh * VDw * Tmax, v_scale + bh * Dg * Tmax,
        v_mn + bh * Dg * Tmax, k_win + bh * W * D, v_win + bh * W * D,
        out + bh * R * D, D, Tmax, gs, k_bits, v_bits, nkq, nkw, nvq,
        lo_ptr ? lo_ptr[b] : 0, sm_scale);
}

template <int R, typename ST>
int launch(const void* q, const void* k_codes, const void* k_scale,
           const void* k_mn, const void* v_codes, const void* v_scale,
           const void* v_mn, const void* k_win, const void* v_win,
           const void* lo, void* out, int B, int H, int D, int Tmax, int W,
           int gs, int k_bits, int v_bits, int nkq, int nkw, int nvq,
           float sm_scale, cudaStream_t stream) {
    const size_t smem = kdec::smem_bytes(R, D, gs, v_bits);
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
