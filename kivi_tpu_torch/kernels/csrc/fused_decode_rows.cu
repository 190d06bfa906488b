// Single-token decode attention over a KIVI cache whose counters differ
// per batch row: the continuous batcher's slot caches.
//
// Replaces the TPU kernel `fused_decode_attention` of
// kivi_tpu/kernels/fused_decode.py (body `_kernel`, one program per
// (row, KV head); under the JAX batcher's vmap over slots its scalar
// counters become per-slot).  Contract:
// kivi_tpu_torch/kernels/fused_decode.py `fused_decode_attention_plain`.
//
// Bound on the H100: bytes.  Each (row, KV head) reads its own row's live
// packed K and V codes, their scale/min rows and the fp windows once: at
// 8 slots of Llama-2-7B (32 KV heads, D 128, KIVI-2, gs 32) filled to
// 1, 137, 640, 1081, 2048, 3000, 4000 and 0 tokens, about 40 MB, 12 us
// at 3.35 TB/s (chip_smoke.py computes it from the run's counters).  The FLOPs (4*r*D per position) are far below the
// card's rate.
//
// Design: one block of 128 threads per (row, KV head), the body
// `kdec::attend` of common.cuh (shared with fused_decode.cu).  Each block
// reads its row's (n_k_quant, n_k_win, n_v_quant) from a (B, 3) int32
// device tensor and its lower bound from an optional (B,) one, so no
// counter passes through the host: the block walks only its row's live
// chunks, skips those wholly below `lo`, and a row with nothing live
// (an empty slot) writes exact zeros.  The counters are clamped into a
// consistent cache state (no-ops for a valid one) so that no read leaves
// the row's stores.

#include "common.cuh"

namespace {

using kdec::NT;

template <int R, typename ST>
__global__ void __launch_bounds__(NT)
fused_decode_rows_kernel(const __nv_bfloat16* __restrict__ q,
                         const uint32_t* __restrict__ k_codes,
                         const ST* __restrict__ k_scale,
                         const ST* __restrict__ k_mn,
                         const uint32_t* __restrict__ v_codes,
                         const ST* __restrict__ v_scale,
                         const ST* __restrict__ v_mn,
                         const __nv_bfloat16* __restrict__ k_win,
                         const __nv_bfloat16* __restrict__ v_win,
                         const int* __restrict__ counts,
                         const int* __restrict__ lo_ptr,
                         float* __restrict__ out, int H, int D, int Tmax,
                         int W, int gs, int k_bits, int v_bits,
                         float sm_scale) {
    extern __shared__ float sm[];
    const long long bh = blockIdx.x;
    const int b = (int)(bh / H);
    // this row's counters: 0 <= nkq <= Tmax, 0 <= nkw <= W,
    // nkq + nkw - W <= nvq <= nkq (the cache invariants)
    const int nkq = min(max(counts[3 * b], 0), Tmax);
    const int nkw = min(max(counts[3 * b + 1], 0), W);
    const int nvq = min(max(counts[3 * b + 2], max(nkq + nkw - W, 0)), nkq);
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
           const void* counts, const void* lo, void* out, int B, int H,
           int D, int Tmax, int W, int gs, int k_bits, int v_bits,
           float sm_scale, cudaStream_t stream) {
    const size_t smem = kdec::smem_bytes(R, D, gs, v_bits);
    auto kern = fused_decode_rows_kernel<R, ST>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<B * H, NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const uint32_t*)k_codes,
        (const ST*)k_scale, (const ST*)k_mn, (const uint32_t*)v_codes,
        (const ST*)v_scale, (const ST*)v_mn, (const __nv_bfloat16*)k_win,
        (const __nv_bfloat16*)v_win, (const int*)counts, (const int*)lo,
        (float*)out, H, D, Tmax, W, gs, k_bits, v_bits, sm_scale);
    return (int)cudaGetLastError();
}

template <typename ST>
int dispatch_r(int r, const void* q, const void* kc, const void* ks,
               const void* km, const void* vc, const void* vs,
               const void* vm, const void* kw, const void* vw,
               const void* counts, const void* lo, void* out, int B, int H,
               int D, int Tmax, int W, int gs, int kb, int vb,
               float sm_scale, cudaStream_t st) {
#define KIVI_R(RR)                                                       \
    case RR:                                                             \
        return launch<RR, ST>(q, kc, ks, km, vc, vs, vm, kw, vw, counts, \
                              lo, out, B, H, D, Tmax, W, gs, kb, vb,     \
                              sm_scale, st);
    switch (r) {
        KIVI_R(1) KIVI_R(2) KIVI_R(4) KIVI_R(8)
        default: return (int)cudaErrorInvalidValue;
    }
#undef KIVI_R
}

}  // namespace

extern "C" int kivi_fused_decode_rows(
        const void* q, const void* k_codes, const void* k_scale,
        const void* k_mn, const void* v_codes, const void* v_scale,
        const void* v_mn, const void* k_win, const void* v_win,
        const void* counts, const void* lo, void* out, int B, int H, int r,
        int D, int Tmax, int W, int gs, int k_bits, int v_bits,
        int scale_is_f32, float sm_scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (scale_is_f32)
        return dispatch_r<float>(r, q, k_codes, k_scale, k_mn, v_codes,
                                 v_scale, v_mn, k_win, v_win, counts, lo,
                                 out, B, H, D, Tmax, W, gs, k_bits, v_bits,
                                 sm_scale, st);
    return dispatch_r<__nv_bfloat16>(r, q, k_codes, k_scale, k_mn, v_codes,
                                     v_scale, v_mn, k_win, v_win, counts,
                                     lo, out, B, H, D, Tmax, W, gs, k_bits,
                                     v_bits, sm_scale, st);
}
